"""CLIP byte-pair-encoding tokenizer (a copy of the JAX package's
``data/clip_tokenizer.py``).

The reference tokenizes CLIP text out-of-band via the external ``clip``
package (``clip.tokenize``; the ablations consume its 77-token id rows,
modeling_ensemble.py:805,834).  This module implements the same
byte-level BPE in-tree so the framework can produce CLIP token ids with
no out-of-band software.

The algorithm is the GPT-2/CLIP byte-level BPE *specification*: UTF-8
bytes are mapped onto 256 printable unicode points, words split by the
CLIP regex are greedily merged by rank over a published merge table, and
every word ends with an explicit ``</w>`` marker.  The byte↔unicode
table and the vocab-assembly order are behavioral constants — any
implementation must reproduce them bit-for-bit or the ids disagree with
the published checkpoints' embedding rows.

Merges come from OpenAI's ``bpe_simple_vocab_16e6.txt.gz`` (pass its
path), or from an explicit list of merge pairs (tests).  Divergence note:
OpenAI additionally runs ``ftfy.fix_text`` before cleaning; ftfy is not
installed here, so mojibake-repair is skipped (identical output on any
well-formed text).  ``regex`` (for the Unicode letter and number classes)
is imported when a tokenizer is built, so the package imports without it.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

_PATTERN = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte→printable-unicode table (GPT-2/CLIP constant)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip().lower()


def load_merges(path: str) -> List[Tuple[str, str]]:
    """Read OpenAI's gzipped merge table (rows 1..49152-256-2 are the
    merges actually used to build the 49408-entry vocab)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    lines = lines[1: 49152 - 256 - 2 + 1]
    return [tuple(line.split()) for line in lines if line.strip()]


class ClipTokenizer:
    """Byte-level BPE with CLIP's vocab layout.

    Vocab order (fixed by the published checkpoints): 256 byte symbols,
    their ``</w>`` variants, one entry per merge, then the two specials —
    49408 total with the full merge table.
    """

    def __init__(self, merges: Union[str, Sequence[Tuple[str, str]]]):
        if isinstance(merges, str):
            merges = load_merges(merges)
        merges = [tuple(m) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {SOT: SOT, EOT: EOT}
        try:  # the CLIP word-split pattern needs \p{L}/\p{N} classes
            import regex
        except ImportError:  # pragma: no cover
            raise ImportError("clip_tokenizer needs the 'regex' package") from None
        self._pat = regex.compile(_PATTERN, regex.IGNORECASE)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT]

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (word[i] == first and i + 1 < len(word)
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self._pat.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) not in (self.sot_id, self.eot_id))
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = 77,
        *,
        truncate: bool = False,
    ) -> np.ndarray:
        """[B, context_length] int32 — ``clip.tokenize`` semantics:
        ``<|startoftext|> tokens <|endoftext|>`` zero-padded; on overflow
        either raise or (``truncate=True``) cut and keep EOT last."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for r, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(
                        f"text {r} is {len(ids)} tokens "
                        f"(> {context_length}): {text[:60]!r}")
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[r, : len(ids)] = ids
        return out


def build_test_merges(words: Iterable[str],
                      max_merges: int = 512) -> List[Tuple[str, str]]:
    """Derive a tiny merge table by running the BPE *training* statistic
    (most-frequent adjacent pair) over ``words`` — for tests only, so the
    suite never needs the 1.3 MB published table."""
    be = bytes_to_unicode()
    corpus: List[List[str]] = []
    for w in words:
        sym = [be[b] for b in w.encode("utf-8")]
        if not sym:
            continue
        sym[-1] += "</w>"
        corpus.append(sym)
    merges: List[Tuple[str, str]] = []
    for _ in range(max_merges):
        counts: Dict[Tuple[str, str], int] = {}
        for sym in corpus:
            for i in range(len(sym) - 1):
                counts[(sym[i], sym[i + 1])] = counts.get(
                    (sym[i], sym[i + 1]), 0) + 1
        if not counts:
            break
        best = max(sorted(counts), key=lambda p: counts[p])
        if counts[best] < 2:
            break
        merges.append(best)
        for sym in corpus:
            i = 0
            while i < len(sym) - 1:
                if sym[i] == best[0] and sym[i + 1] == best[1]:
                    sym[i: i + 2] = [best[0] + best[1]]
                else:
                    i += 1
    return merges
