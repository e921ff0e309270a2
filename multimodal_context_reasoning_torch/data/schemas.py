"""Typed example schemas for the PMR / VCR pipelines (a copy of the JAX
package's ``data/schemas.py``).

The reference feeds pickled dicts with implicit schemas
(Data/VCRChunkAlign.py:529-688); here every record passing between pipeline
stages is an explicit dataclass. One :class:`CandidateFeatures` is one
(example, answer-candidate) pair — the reference expands each example into 4
candidate tuples inside ``__getitem__`` (Data/VCRChunkAlign.py:615-687).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RawExample:
    """One raw PMR/VCR example before tokenization."""

    example_id: str
    img_id: str
    premise: str                      # detokenized, <|det#|> region tokens inline
    answer_choices: List[str]
    answer_label: Optional[object]    # int, or list of ints (PMR multi-label)
    answer_types: Optional[List[int]] = None
    objects: Optional[List[str]] = None
    rationale: Optional[str] = None   # gold explanation (gpt-stream datasets)


@dataclasses.dataclass
class ImageFeatures:
    """Pre-extracted Faster-RCNN region features for one image."""

    features: np.ndarray              # [num_regions, img_feature_dim] float32
    num_regions: int


@dataclasses.dataclass
class CandidateFeatures:
    """Tokenized features of one (example, candidate) pair.

    Mirrors the per-candidate tuple of the reference dataset
    (Data/VCRChunkAlign.py:684-687), minus the device placement (the
    reference creates CUDA tensors inside ``__getitem__``; we emit numpy and
    transfer once per batch).
    """

    input_ids: np.ndarray             # [t] BERT ids: [CLS] premise [SEP] ans [SEP]
    token_type_ids: np.ndarray        # [t] 0 = premise+CLS+SEP, 1 = answer+SEP
    gather_index: np.ndarray          # [t] chunk id per position, -1 outside
    total_label: np.ndarray           # [t] region index per <|det#|> token
    align_pos: np.ndarray             # [t] 1 where total_label != 0
    r_input_ids: np.ndarray           # [r] RoBERTa ids: <s> prompt+premise </s> ans </s>
    r_token_type_ids: np.ndarray      # [r] zeros (type embeddings re-initialised)
    target: float                     # 1.0 if this candidate is correct
