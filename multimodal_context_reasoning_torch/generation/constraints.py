"""Attention-derived lexical constraints for beam sampling (a copy of the
JAX package's ``generation/constraints.py``: host-side numpy, the same
masks).

Reference (modeling_vcr_chunkalign_v10.py:2107-2133): rank input tokens by
their summed ClsLayer attention weight, drop stopwords / wordpiece
continuations / special tokens, take the top-``max_constraints`` surviving
words, and re-encode each (with a leading space, GPT-2 BPE convention) into
decoder-vocabulary ids whose beam scores get boosted.

Host-side by design: it manipulates token *strings* between two tokenizers;
the output is a dense ``[B, V]`` boolean mask consumed by the beam loop
(generation/beam.py) — the only device-visible artifact.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

# Compact English stopword list (the reference loads NLTK's at :2100; the
# exact list only gates which *constraint* words survive, not correctness).
STOPWORDS = frozenset(
    """a an the and or but if of in on at to for with by from as is are was
    were be been being will would can could should that this these those it
    its he she they them his her their i you we us our your my me do does
    did done have has had having not no nor so than then there here what
    which who whom when where why how all any both each few more most other
    some such only own same too very s t don now""".split()
)


def extract_constraint_words(
    tokens: Sequence[str],
    attention: Sequence[float],
    *,
    max_constraints: int = 5,
    extra_stopwords: Optional[Sequence[str]] = None,
) -> List[str]:
    """Top-attended full words, stopwords and special/wordpiece tokens dropped.

    ``tokens``/``attention`` are the encoder-side (BERT) tokens and their
    summed ClsLayer attention weights (one float per token).
    """
    stop = STOPWORDS if extra_stopwords is None else STOPWORDS | set(extra_stopwords)
    order = np.argsort(-np.asarray(attention, np.float32))
    out: List[str] = []
    for i in order:
        tok = tokens[int(i)]
        if tok.startswith("##") or tok.startswith("["):
            continue
        if tok.startswith("<|det") or tok in ("<s>", "</s>", "<mask>"):
            continue
        w = tok.lower()
        if w in stop or not any(ch.isalnum() for ch in w):
            continue
        if w in out:
            continue
        out.append(w)
        if len(out) >= max_constraints:
            break
    return out


def constraint_vocab_mask(
    words: Sequence[str],
    encode_fn: Callable[[str], Sequence[int]],
    vocab_size: int,
) -> np.ndarray:
    """[V] bool mask of decoder-vocab ids whose scores the beam boosts.

    ``encode_fn`` maps a string to decoder token ids (e.g. a GPT-2 BPE
    ``tokenizer.encode``).  Words are encoded with a leading space — GPT-2's
    word-initial form — matching the reference's re-encoding step (:2122-2133).
    """
    mask = np.zeros((vocab_size,), bool)
    for w in words:
        for tid in encode_fn(" " + w):
            if 0 <= tid < vocab_size:
                mask[tid] = True
    return mask


def extract_constraints(
    batch_tokens: Sequence[Sequence[str]],
    batch_attention: Sequence[Sequence[float]],
    encode_fn: Callable[[str], Sequence[int]],
    vocab_size: int,
    *,
    max_constraints: int = 5,
) -> np.ndarray:
    """Batched: [B, V] bool constraint mask for constrained_beam_sample."""
    return np.stack([
        constraint_vocab_mask(
            extract_constraint_words(toks, attn, max_constraints=max_constraints),
            encode_fn, vocab_size,
        )
        for toks, attn in zip(batch_tokens, batch_attention)
    ])
