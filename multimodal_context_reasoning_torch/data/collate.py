"""Static-shape candidate batching (a copy of the JAX package's
``data/collate.py``).

Every batch is padded to the fixed geometry of :class:`BatchSpec`; each
example contributes ``num_labels`` consecutive candidate rows (the
reference's unzip-concat flattening, Data/VCRChunkAlign.py:692-693).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from multimodal_context_reasoning_torch.data.schemas import CandidateFeatures, ImageFeatures


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    text_len: int = 80
    img_len: int = 50
    roberta_len: int = 128
    num_labels: int = 4
    img_feature_dim: int = 2054
    bert_pad_id: int = 0
    roberta_pad_id: int = 1


def pad_to(x: np.ndarray, length: int, value=0) -> np.ndarray:
    """Pad or truncate a 1-D array to ``length``."""
    x = np.asarray(x)
    if x.shape[0] >= length:
        return x[:length]
    out = np.full((length,) + x.shape[1:], value, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def collate_candidates(
    candidates: Sequence[Sequence[CandidateFeatures]],  # [B][num_labels]
    images: Optional[Sequence[ImageFeatures]],          # [B], or None
    spec: BatchSpec,
) -> Dict[str, np.ndarray]:
    """[B] examples × num_labels candidates → flat [B·num_labels] batch.

    ``images=None`` (device-table mode, data/device_table.py) leaves out
    ``img_feat`` / ``img_mask``: the caller adds the rows' table ids."""
    B = len(candidates)
    K = spec.num_labels
    N = B * K
    T, I, R = spec.text_len, spec.img_len, spec.roberta_len

    out = {
        "input_ids": np.zeros((N, T), np.int32),
        "token_type_ids": np.zeros((N, T), np.int32),
        "text_mask": np.zeros((N, T), np.float32),
        "gather_index": np.full((N, T), -1, np.int32),
        "total_label": np.zeros((N, T), np.int32),
        "align_pos": np.zeros((N, T), np.int32),
        "r_input_ids": np.full((N, R), spec.roberta_pad_id, np.int32),
        "r_token_type_ids": np.zeros((N, R), np.int32),
        "r_attention_mask": np.zeros((N, R), np.float32),
        "img_feat": np.zeros((N, I, spec.img_feature_dim), np.float32),
        "img_mask": np.zeros((N, I), np.float32),
        "label": np.zeros((N,), np.float32),
    }

    if images is None:
        del out["img_feat"], out["img_mask"]
        images = [None] * B

    for b, (cands, img) in enumerate(zip(candidates, images)):
        if len(cands) != K:
            raise ValueError(f"expected {K} candidates, got {len(cands)}")
        if img is not None:
            n_reg = min(img.num_regions, I)
            feats = img.features[:n_reg].astype(np.float32)
        for k, c in enumerate(cands):
            n = b * K + k
            t = min(len(c.input_ids), T)
            out["input_ids"][n] = pad_to(np.asarray(c.input_ids, np.int32), T, spec.bert_pad_id)
            out["token_type_ids"][n] = pad_to(np.asarray(c.token_type_ids, np.int32), T)
            out["text_mask"][n, :t] = 1.0
            out["gather_index"][n] = pad_to(np.asarray(c.gather_index, np.int32), T, -1)
            out["total_label"][n] = pad_to(np.asarray(c.total_label, np.int32), T)
            out["align_pos"][n] = pad_to(np.asarray(c.align_pos, np.int32), T)
            r = min(len(c.r_input_ids), R)
            out["r_input_ids"][n] = pad_to(
                np.asarray(c.r_input_ids, np.int32), R, spec.roberta_pad_id
            )
            out["r_token_type_ids"][n] = pad_to(np.asarray(c.r_token_type_ids, np.int32), R)
            out["r_attention_mask"][n, :r] = 1.0
            if img is not None:
                out["img_feat"][n, :n_reg] = feats
                out["img_mask"][n, :n_reg] = 1.0
            out["label"][n] = np.float32(c.target)

    return out


def table_rows(table, img_ids: Sequence[str], num_labels: int) -> np.ndarray:
    """[B·num_labels] int32 table row of each candidate row (device-table
    mode): each example's row, repeated for its candidates."""
    return np.repeat(np.asarray([table.row_for(i) for i in img_ids], np.int32), num_labels)
