"""In-tree subword tokenizers: WordPiece (BERT) and byte-level BPE
(RoBERTa/GPT-2), plus a corpus-trained WordPiece vocab trainer (a copy of
the JAX package's ``data/subword.py``).

The reference tokenizes with HuggingFace ``BertTokenizerFast`` /
``RobertaTokenizer`` loaded from local checkpoint dirs, with 45
``<|det#|>`` region tokens appended as special tokens
(run_PMR_ModCR.py:713-716, 775-777).  These are clean-room
implementations of the same two public algorithms, self-contained:

- ``WordPieceTokenizer``: BERT basic tokenization (control-char cleanup,
  optional lowercase + accent stripping, punctuation isolation, CJK
  spacing) followed by greedy longest-match WordPiece with ``##``
  continuations.  Loads a standard ``vocab.txt`` (one token per line,
  id = line number).
- ``ByteBPETokenizer``: GPT-2's reversible byte→unicode alphabet, the
  GPT-2 pre-tokenization regex, and ranked merge BPE.  Loads standard
  ``vocab.json`` + ``merges.txt``.
- ``train_wordpiece``: a likelihood-scored WordPiece trainer so hermetic
  environments (no pretrained vocab anywhere on disk) can build a real
  collision-free subword vocab from the task corpus itself instead of
  falling back to md5 hash buckets.

Both tokenizers satisfy the ``Tokenizer`` protocol (data/tokenization.py)
and keep ``<|det#|>`` tokens atomic with dedicated ids, mirroring the
reference's ``add_special_tokens`` append: det ids start at the end of
the file vocab, exactly like HF assigns added tokens len(vocab)+i.

tests/test_torch_data.py holds this copy to the JAX package's on files the
test writes: the same tokens and ids, and the same trained vocab.
"""

from __future__ import annotations

import json
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from multimodal_context_reasoning_torch.data.tokenization import (
    DET_TOKENS,
    _DET_RE,
)

# ---------------------------------------------------------------------------
# BERT basic tokenization


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric printable ranges count as punctuation even
    # where unicode disagrees (e.g. "$", "^", "`") — BERT convention.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(
    text: str, *, lowercase: bool = True,
    never_split: Optional[Sequence[str]] = None,
) -> List[str]:
    """BERT's BasicTokenizer: cleanup → whitespace split → (lowercase,
    strip accents, punctuation isolation) per token, CJK chars isolated."""
    never = set(never_split or ())

    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned.append(f" {ch} ")
        elif _is_whitespace(ch):
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    out: List[str] = []
    for tok in "".join(cleaned).split():
        if tok in never:
            out.append(tok)
            continue
        if lowercase:
            tok = tok.lower()
            tok = "".join(
                c for c in unicodedata.normalize("NFD", tok)
                if unicodedata.category(c) != "Mn"
            )
        run: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if run:
                    out.append("".join(run))
                    run = []
                out.append(ch)
            else:
                run.append(ch)
        if run:
            out.append("".join(run))
    return out


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a ``vocab.txt`` vocabulary.

    ``det_tokens=True`` appends the 45 ``<|det#|>`` region tokens after
    the file vocab (ids len(vocab)..len(vocab)+44), matching the
    reference's added-special-token id assignment.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        *,
        lowercase: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        det_tokens: bool = True,
        max_chars_per_word: int = 100,
    ):
        self.vocab = dict(vocab)
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.max_chars_per_word = max_chars_per_word
        if det_tokens:
            base = len(self.vocab)
            for i, t in enumerate(DET_TOKENS):
                self.vocab.setdefault(t, base + i)
        self.pad_id = self.vocab.get(pad_token, 0)
        # "<mask>" is not in this set, so a roberta-style vocab splits it
        # into "<", "mask", ">" (PMR's prompt holds it twice).  Kept as the
        # JAX package has it, so both give the same ids.
        self._never_split = set(
            [unk_token, cls_token, sep_token, pad_token, "[MASK]"]
        ) | set(DET_TOKENS)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    @classmethod
    def from_roberta_style_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        """Reload a ``corpus_wordpiece_tokenizer(style="roberta")`` vocab:
        WordPiece segmentation presented through RoBERTa surface
        conventions (``<s>``/``</s>``/``<unk>``, pad id 1)."""
        return cls.from_vocab_file(
            path, unk_token="<unk>", cls_token="<s>", sep_token="</s>",
            pad_token="<pad>",
        )

    def save_vocab_file(self, path: str) -> None:
        """Write the vocab one token per line in id order (including the
        appended ``<|det#|>`` rows); ``from_vocab_file`` — or
        ``from_roberta_style_vocab_file`` for roberta-style tokenizers —
        reproduces identical ids.  Persisting the corpus-trained vocab
        next to a run's checkpoints is what makes the checkpoints
        servable later: ids are meaningless without it."""
        items = sorted(self.vocab.items(), key=lambda kv: kv[1])
        for i, (tok, idx) in enumerate(items):
            if i != idx:
                raise ValueError(
                    f"non-dense vocab: token {tok!r} has id {idx} at "
                    f"position {i}; the line-number=id file contract "
                    f"cannot represent it")
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in items:
                f.write(tok + "\n")

    def __len__(self) -> int:
        return len(self.vocab)

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in basic_tokenize(
            text, lowercase=self.lowercase, never_split=self._never_split
        ):
            if word in self._never_split:
                out.append(word)
            else:
                out.extend(self._wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]


# ---------------------------------------------------------------------------
# GPT-2 / RoBERTa byte-level BPE

# GPT-2's pre-tokenization pattern (contractions, letter runs, number
# runs, other-symbol runs, trailing whitespace handling).
_GPT2_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode alphabet: printable bytes
    map to themselves, the rest to U+0100.. in order."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_ENC = bytes_to_unicode()


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


class ByteBPETokenizer:
    """Byte-level BPE with ranked merges (GPT-2/RoBERTa encoding).

    RoBERTa conventions by default: ``<s>``/``</s>``/``<pad>`` (pad id 1
    in the standard vocab).  ``det_tokens=True`` appends the 45
    ``<|det#|>`` tokens after the file vocab (run_PMR_ModCR.py:775-777).
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        *,
        unk_token: str = "<unk>",
        cls_token: str = "<s>",
        sep_token: str = "</s>",
        pad_token: str = "<pad>",
        det_tokens: bool = True,
    ):
        self.vocab = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.unk_token = unk_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        if det_tokens:
            base = len(self.vocab)
            for i, t in enumerate(DET_TOKENS):
                self.vocab.setdefault(t, base + i)
        self.pad_id = self.vocab.get(pad_token, 1)
        self._cache: Dict[str, List[str]] = {}
        # atomic specials survive pre-tokenization via a priority split
        self._special = sorted(
            (t for t in (cls_token, sep_token, pad_token, unk_token, "<mask>")
             if t in self.vocab),
            key=len, reverse=True,
        ) + DET_TOKENS
        # ``regex`` (for ``\p{L}``) is imported here: only this tokenizer
        # needs it, so the WordPiece half loads without it
        import regex

        self._special_pat = regex.compile(
            "(" + "|".join(regex.escape(t) for t in self._special) + ")"
        )
        self._gpt2_pat = regex.compile(_GPT2_PATTERN)

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str, **kw) -> "ByteBPETokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    def __len__(self) -> int:
        return len(self.vocab)

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        while len(word) > 1:
            pairs = _get_pairs(word)
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for segment in self._special_pat.split(text):
            if not segment:
                continue
            if segment in self.vocab and (
                segment in self._special or _DET_RE.fullmatch(segment)
            ):
                out.append(segment)
                continue
            for piece in self._gpt2_pat.findall(segment):
                mapped = "".join(_BYTE_ENC[b] for b in piece.encode("utf-8"))
                out.extend(self._bpe(mapped))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token, 3)
        return [self.vocab.get(t, unk) for t in tokens]


# ---------------------------------------------------------------------------
# Corpus-trained WordPiece (the hermetic-recipe vocab trainer)


def train_wordpiece(
    texts: Iterable[str],
    *,
    vocab_size: int = 8192,
    lowercase: bool = True,
    specials: Sequence[str] = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"),
    min_pair_freq: int = 2,
) -> Dict[str, int]:
    """Train a WordPiece vocab by likelihood-scored pair merging (the HF
    WordPiece trainer's objective: score = freq(ab) / (freq(a)·freq(b))).

    Returns a vocab dict loadable by ``WordPieceTokenizer`` — specials
    first, then single characters, then merged units.  ``<|det#|>``
    tokens are NOT included: the tokenizer appends them (reference
    semantics), so budget ``vocab_size`` accordingly.
    """
    word_freq: Counter = Counter()
    for text in texts:
        for w in basic_tokenize(text, lowercase=lowercase):
            if _DET_RE.fullmatch(w):
                continue  # handled as appended specials by the tokenizer
            word_freq[w] += 1

    # symbol sequences: first char bare, continuations ##-prefixed
    words: Dict[str, List[str]] = {
        w: [w[0]] + ["##" + c for c in w[1:]] for w in word_freq
    }
    vocab: Dict[str, int] = {t: i for i, t in enumerate(specials)}
    for syms in words.values():
        for s in syms:
            if s not in vocab:
                vocab[s] = len(vocab)

    # incremental pair/symbol stats: one full pass up front, then per-merge
    # updates touch only the words containing the merged pair (the full
    # recount is O(merges × corpus) — minutes in Python at vocab 8k)
    pair_freq: Counter = Counter()
    sym_freq: Counter = Counter()
    pair_words: Dict[Tuple[str, str], set] = {}
    for w, syms in words.items():
        f = word_freq[w]
        for s in syms:
            sym_freq[s] += f
        for p in zip(syms, syms[1:]):
            pair_freq[p] += f
            pair_words.setdefault(p, set()).add(w)

    def _apply(w: str, a: str, b: str, new_sym: str) -> None:
        syms, f = words[w], word_freq[w]
        for s in syms:
            sym_freq[s] -= f
        for p in zip(syms, syms[1:]):
            pair_freq[p] -= f
            if pair_freq[p] <= 0:
                del pair_freq[p]
            ws = pair_words.get(p)
            if ws is not None:
                ws.discard(w)
        merged: List[str] = []
        i = 0
        while i < len(syms):
            if i < len(syms) - 1 and syms[i] == a and syms[i + 1] == b:
                merged.append(new_sym)
                i += 2
            else:
                merged.append(syms[i])
                i += 1
        words[w] = merged
        for s in merged:
            sym_freq[s] += f
        for p in zip(merged, merged[1:]):
            pair_freq[p] += f
            pair_words.setdefault(p, set()).add(w)

    while len(vocab) < vocab_size and pair_freq:
        # Likelihood scoring favors RARE pairs (small denominators), so the
        # frequency floor must be a candidacy filter, not a stop condition:
        # breaking when the best-scored pair was rare ended training after
        # ~one merge and produced a character-level vocab (the round-5
        # regression test pins the non-degenerate behavior).
        candidates = [
            (p, f) for p, f in pair_freq.items() if f >= min_pair_freq
        ]
        if not candidates:
            break
        best, bf = max(
            candidates,
            key=lambda kv: (
                kv[1] / (sym_freq[kv[0][0]] * sym_freq[kv[0][1]]),
                kv[1],
                kv[0],  # deterministic tie-break
            ),
        )
        a, b = best
        new_sym = a + b[2:] if b.startswith("##") else a + b
        # two merge paths can yield the same string (("a","##bc") and
        # ("ab","##c") → "abc"): consume the pair either way, add once
        if new_sym not in vocab:
            vocab[new_sym] = len(vocab)
        for w in list(pair_words.get((a, b), ())):
            _apply(w, a, b, new_sym)
        pair_freq.pop((a, b), None)
    return vocab


def corpus_wordpiece_tokenizer(
    texts: Iterable[str],
    *,
    vocab_size: int = 8192,
    style: str = "bert",
) -> WordPieceTokenizer:
    """One-call hermetic tokenizer: train WordPiece on ``texts`` and wrap
    it with BERT or RoBERTa surface conventions.

    ``style="roberta"`` keeps WordPiece segmentation (the reasoner does
    not care which subword scheme produced the ids — only that they are
    collision-free and consistent) but presents ``<s>``/``</s>``/pad id 1
    so featurizers built for RoBERTa conventions work unchanged.
    """
    if style == "bert":
        vocab = train_wordpiece(texts, vocab_size=vocab_size)
        return WordPieceTokenizer(vocab)
    if style == "roberta":
        specials = ("<s>", "<pad>", "</s>", "<unk>", "<mask>")
        vocab = train_wordpiece(texts, vocab_size=vocab_size, specials=specials)
        return WordPieceTokenizer(
            vocab, unk_token="<unk>", cls_token="<s>", sep_token="</s>",
            pad_token="<pad>",
        )
    raise ValueError(f"unknown style: {style}")
