"""Tokenizers: a copy of the JAX package's ``data/tokenization.py``.

The reference uses HuggingFace ``BertTokenizerFast`` / ``RobertaTokenizer``
with 45 ``<|det#|>`` region tokens appended as special tokens
(run_PMR_ModCR.py:713-716, 775-777).  :class:`HFTokenizer` adapts such a
tokenizer, loaded by the caller from a local directory
(:func:`hf_tokenizer_from_dir`; ``transformers`` is imported only there, so
the package imports without it).  The hash tokenizers are the
self-contained stand-ins for tests, dry runs and benchmarks; any object with
the :class:`Tokenizer` protocol can replace them.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Protocol, Sequence

NUM_DET_TOKENS = 45  # run_PMR_ModCR.py:715: "<|det%d|>" % i for i in range(45)


def det_token(i: int) -> str:
    return f"<|det{i}|>"


DET_TOKENS = [det_token(i) for i in range(NUM_DET_TOKENS)]
_DET_RE = re.compile(r"<\|det(\d+)\|>")


def det_index(token: str) -> Optional[int]:
    """Region index of a ``<|det#|>`` token, else None.

    Mirrors the dataset's substring parse (Data/VCRChunkAlign.py:646-649).
    """
    m = _DET_RE.fullmatch(token)
    return int(m.group(1)) if m else None


class Tokenizer(Protocol):
    cls_token: str
    sep_token: str
    pad_id: int

    def tokenize(self, text: str) -> List[str]: ...
    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]: ...


class HFTokenizer:
    """Adapter around a HuggingFace tokenizer instance (loaded by the caller
    from a local path — no hub access is assumed)."""

    def __init__(self, hf_tokenizer, add_det_tokens: bool = True):
        self._tok = hf_tokenizer
        if add_det_tokens:
            self._tok.add_special_tokens({"additional_special_tokens": DET_TOKENS})
        self.cls_token = getattr(hf_tokenizer, "cls_token", None) or hf_tokenizer.bos_token
        self.sep_token = getattr(hf_tokenizer, "sep_token", None) or hf_tokenizer.eos_token
        self.pad_id = hf_tokenizer.pad_token_id or 0

    def __len__(self):
        return len(self._tok)

    def tokenize(self, text: str) -> List[str]:
        return self._tok.tokenize(text)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return self._tok.convert_tokens_to_ids(list(tokens))


def import_transformers(flag: str):
    """The ``transformers`` module; ``SystemExit`` naming it and ``flag``
    when it is not installed (there is no fallback tokenizer for a flag that
    names a directory)."""
    try:
        import transformers
    except ImportError as e:
        raise SystemExit(f"{flag} needs the 'transformers' package, which is not "
                         f"installed ({e})") from e
    return transformers


def hf_tokenizer_from_dir(path: str, flag: str, *, add_det_tokens: bool = True) -> HFTokenizer:
    """``AutoTokenizer.from_pretrained(path)`` (a local directory) as an
    :class:`HFTokenizer`."""
    transformers = import_transformers(flag)
    return HFTokenizer(transformers.AutoTokenizer.from_pretrained(path),
                       add_det_tokens=add_det_tokens)


class HashTokenizer:
    """Deterministic hash-bucket whitespace tokenizer.

    A hermetic stand-in when no pretrained vocab is available (tests,
    dry-runs, benchmarking). ``<|det#|>`` tokens get stable dedicated ids at
    the top of the vocab, mirroring the special-token append.
    """

    def __init__(self, vocab_size: int = 30567, cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_id: int = 0):
        self.vocab_size = vocab_size
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.pad_id = pad_id
        self._special = {cls_token: 1, sep_token: 2, "<mask>": 3}
        base = vocab_size - NUM_DET_TOKENS
        for i, t in enumerate(DET_TOKENS):
            self._special[t] = base + i
        self._floor = 4

    def __len__(self):
        return self.vocab_size

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for piece in text.strip().split():
            # keep <|det#|> atomic, split leading/trailing punctuation
            if _DET_RE.fullmatch(piece):
                out.append(piece)
                continue
            out.extend(re.findall(r"<\|det\d+\|>|\w+|[^\w\s]", piece.lower()))
        return out

    def _bucket(self, token: str) -> int:
        h = int.from_bytes(hashlib.md5(token.encode()).digest()[:4], "little")
        span = self.vocab_size - NUM_DET_TOKENS - self._floor
        return self._floor + (h % span)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self._special.get(t, self._bucket(t)) for t in tokens]


class RobertaHashTokenizer(HashTokenizer):
    """Hash tokenizer with RoBERTa conventions (<s>, </s>, pad=1)."""

    def __init__(self, vocab_size: int = 50310):
        super().__init__(vocab_size, cls_token="<s>", sep_token="</s>", pad_id=1)
        self._special["<s>"] = 0
        self._special["</s>"] = 2
        self._floor = 4
