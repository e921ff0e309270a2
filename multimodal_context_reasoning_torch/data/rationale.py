"""Explanation (rationale) data streams for the generation models (a copy
of the JAX package's ``data/rationale.py``).

The reference's gpt-stream dataset (``VCR_ChunkAlign_Dataset_align_ensemble_gpt``,
Data/VCRChunkAlign.py:356-527) extends the candidate tuples with GPT-2
token streams of the gold explanation, wrapped in ``<|b_rtnl|>`` /
``<|e_rtnl|>`` markers (the rationale models encode those boundaries,
modeling_vcr_chunkalign_v10.py:1338-1339).  This module adds the same
capability over the framework's featurizer: one explanation stream per
*question* (the reference keeps only candidate 0's copy of the 4 identical
streams, v10.py:1399-1401 — here it is never duplicated in the first place).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_context_reasoning_torch.data.collate import pad_to
from multimodal_context_reasoning_torch.data.tokenization import Tokenizer

B_RTNL = "<|b_rtnl|>"
E_RTNL = "<|e_rtnl|>"


@dataclasses.dataclass(frozen=True)
class RationaleSpec:
    max_len: int = 64
    pad_id: int = 0


def featurize_rationale(
    rationale_text: str,
    gpt_tokenizer: Tokenizer,
    spec: RationaleSpec,
) -> Dict[str, np.ndarray]:
    """One explanation string → fixed-shape GPT streams.

    ``expl_ids`` carries the marker-wrapped tokens; ``gpt_labels`` equals it
    with pad positions ignored by the XE loss (models/rationale.py masks on
    pad_token_id, matching the reference's ignore_index CE, v10.py:1336).
    """
    toks = ([B_RTNL] + gpt_tokenizer.tokenize(rationale_text.strip())
            + [E_RTNL])
    ids = np.asarray(gpt_tokenizer.convert_tokens_to_ids(toks), np.int32)
    L = spec.max_len
    out_ids = pad_to(ids, L, spec.pad_id)
    mask = np.zeros((L,), np.float32)
    mask[: min(len(ids), L)] = 1.0
    return {
        "expl_ids": out_ids,
        "gpt_labels": out_ids.copy(),
        "expl_mask": mask,
    }


def collate_rationales(
    rationales: Sequence[Optional[str]],
    gpt_tokenizer: Tokenizer,
    spec: Optional[RationaleSpec] = None,
) -> Dict[str, np.ndarray]:
    """[Q] explanation strings → batched streams (missing → all-pad rows)."""
    spec = spec or RationaleSpec()
    rows: List[Dict[str, np.ndarray]] = []
    for r in rationales:
        if r:
            rows.append(featurize_rationale(r, gpt_tokenizer, spec))
        else:
            rows.append({
                "expl_ids": np.full((spec.max_len,), spec.pad_id, np.int32),
                "gpt_labels": np.full((spec.max_len,), spec.pad_id, np.int32),
                "expl_mask": np.zeros((spec.max_len,), np.float32),
            })
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
