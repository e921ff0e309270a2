"""Phrase-chunk assignment for the ChunkAlign mask schedule (a copy of the
JAX package's ``data/chunker.py`` without its reference-mask function).

The reference precomputes phrase chunks *offline* with a BERT + AdapterHub
CoNLL-2000 chunking adapter (utils/GetChunk_v4_vcr.py:20-22) and pickles a
per-candidate ``{mask, offsets}`` dict (:149-159).  The chunk masks are a
*model input*, so the capability must exist in-framework.

This module provides:

- :func:`chunks_from_bio` — turn any tagger's B/I/O tags into chunk offsets
  (exactly the grouping loop of GetChunk_v4_vcr.py:104-148);
- :class:`HeuristicChunker` — a dependency-free fallback tagger grouping
  consecutive content tokens into phrases (splitting at punctuation and
  function words), for use when the pretrained chunking adapter is not on
  disk. Plug a real tagger in via the ``tag_fn`` hook for parity runs.

Chunk assignments are emitted as a flat ``gather_index`` (chunk id per token
position, -1 outside any chunk) — the dense [T, T] block mask is synthesized
on the device by ops/chunk.py:chunk_mask_from_gather_index, so nothing quadratic
is stored or shipped.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

# Function words that terminate a heuristic phrase (rough CoNLL-2000-style
# NP/VP boundaries).
_BOUNDARY = {
    "a", "an", "the", "and", "or", "but", "if", "of", "in", "on", "at", "to",
    "for", "with", "by", "from", "as", "is", "are", "was", "were", "be",
    "been", "being", "will", "would", "can", "could", "should", "that",
    "this", "these", "those", "it", "its", "他", "她",
}
_PUNCT = set(".,!?;:'\"()[]{}")


def heuristic_bio_tags(tokens: Sequence[str]) -> List[str]:
    """Assign B/I/O tags: content-word runs become phrases."""
    tags: List[str] = []
    in_phrase = False
    for tok in tokens:
        t = tok.lower().lstrip("##")  # wordpiece continuations share the word
        if t in _PUNCT or t in _BOUNDARY:
            tags.append("O")
            in_phrase = False
        elif tok.startswith("##") and in_phrase:
            tags.append("I")
        else:
            tags.append("I" if in_phrase else "B")
            in_phrase = True
    return tags


def chunks_from_bio(tags: Sequence[str]) -> List[List[int]]:
    """B/I/O tags (one per token) → list of position lists (chunk offsets).

    Exact transcription of the reference chunking script's grouping loop
    (utils/GetChunk_v4_vcr.py:117-141), including its three quirks:

    - a *dangling I* (no open chunk) STARTS a chunk (:126-129 appends to the
      empty ``tmp_chunk``);
    - an O token whose successor is I while a chunk is open is *bridged*
      into that chunk (:131-136); the last interior position never bridges;
    - a singleton O does NOT flush the open chunk (:137-138 only records the
      singleton), so a later I can resume the pre-O chunk.

    Tags may be bare ("B") or typed ("B-NP"); only the first letter is read,
    as the reference does (``token_class[0]``).  Singleton O positions are
    not returned (they carry no block structure — identity row either way).
    """
    chunks: List[List[int]] = []
    cur: List[int] = []
    n = len(tags)
    for i, tag in enumerate(tags):
        head = tag[0].upper() if tag else "O"
        if head == "B":
            if cur:
                chunks.append(cur)
            cur = [i]
        elif head == "I":
            cur.append(i)
        else:  # O
            if i != n - 1 and cur and tags[i + 1][:1].upper() == "I":
                cur.append(i)
            # else: singleton; the open chunk stays open (reference :138)
    if cur:
        chunks.append(cur)
    return chunks


class HeuristicChunker:
    """Chunk assigner with a pluggable tagger.

    ``tag_fn(tokens) -> BIO tags``; defaults to :func:`heuristic_bio_tags`.
    """

    def __init__(self, tag_fn: Optional[Callable[[Sequence[str]], List[str]]] = None):
        self.tag_fn = tag_fn or heuristic_bio_tags

    def gather_index(self, tokens: Sequence[str], *, offset: int = 1,
                     total_len: Optional[int] = None,
                     max_chunks: Optional[int] = None) -> np.ndarray:
        """Chunk id per position of the *full* sequence.

        ``tokens`` are the text tokens *between* CLS and the final SEP;
        ``offset`` shifts their positions (1 for the leading CLS).  Positions
        outside chunks (CLS, SEPs, padding) get -1.
        """
        L = total_len if total_len is not None else offset + len(tokens) + 1
        out = np.full((L,), -1, dtype=np.int32)
        chunks = chunks_from_bio(self.tag_fn(tokens))
        if max_chunks is not None:
            chunks = chunks[:max_chunks]
        for cid, members in enumerate(chunks):
            for pos in members:
                p = pos + offset
                if p < L:
                    out[p] = cid
        return out
