"""Attention-mask program of the ChunkAlign staged schedule.

Port of the JAX package's ``ops/masks.py``.  Two forms of the same masks:

- :func:`build_stage_biases` / :func:`padding_bias`: dense additive biases,
  ``0.0`` visible and ``NEG_INF = -10000.0`` masked (the reference's
  ``(1.0 - m) * -10000.0``), for the plain attention path that returns
  probabilities;
- :func:`stage_mask_specs`: the compact per-token :class:`MaskSpec` the
  stage-mask kernel (ops/spec_attention.py) rebuilds the mask from.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -10000.0


class MaskSpec(NamedTuple):
    """Compact encoding of one stage's attention mask.

    - ``valid``  [B, L] fp32: real-token mask over the joint text‖image
      stream (column visibility);
    - ``gi``     [B, L] int32: phrase-chunk id per text position, -1 outside
      chunks and everywhere in the image block;
    - ``rowfull``[B, L] fp32: all-visible rows, CLS (position 0) and the
      final real text position.

    ``stage`` ("chunk" | "full" | "cross") and ``text_len`` are static.
    """

    stage: str
    valid: torch.Tensor
    gi: torch.Tensor
    rowfull: torch.Tensor
    text_len: int


def stage_mask_specs(text_mask: torch.Tensor, img_mask: torch.Tensor,
                     gather_index: torch.Tensor):
    """(spec_chunk, spec_full, spec_cross): vector form of
    :func:`build_stage_biases` for gather-index-derived chunk masks."""
    B, T = text_mask.shape
    I = img_mask.shape[1]
    dev = text_mask.device
    valid = torch.cat([text_mask.float(), img_mask.float()], dim=-1).contiguous()
    gi = torch.cat(
        [gather_index.to(torch.int32),
         torch.full((B, I), -1, dtype=torch.int32, device=dev)], dim=-1,
    ).contiguous()
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    lengths = text_mask.to(torch.int32).sum(dim=1)
    row_t = (pos == 0) | (pos == (lengths - 1)[:, None])
    rowfull = torch.cat(
        [row_t.float(), torch.zeros((B, I), device=dev)], dim=-1
    ).contiguous()
    return (
        MaskSpec("chunk", valid, gi, rowfull, T),
        MaskSpec("full", valid, gi, rowfull, T),
        MaskSpec("cross", valid, gi, rowfull, T),
    )


def full_mask_spec(valid: torch.Tensor, text_len: int) -> MaskSpec:
    """The "full" stage over a [B, Lk] validity vector: only the columns'
    validity matters, so ``gi`` is all -1 and ``rowfull`` all 0."""
    B, L = valid.shape
    return MaskSpec(
        "full", valid.float().contiguous(),
        torch.full((B, L), -1, dtype=torch.int32, device=valid.device),
        torch.zeros((B, L), device=valid.device), text_len,
    )


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] {0,1} keep-mask -> [B, 1, 1, L] fp32 additive bias."""
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]


def build_stage_biases(text_mask: torch.Tensor, img_mask: torch.Tensor,
                       chunk_mask: torch.Tensor):
    """The three stage biases ``(bias_chunk, bias_full, bias_cross)``;
    bias_chunk and bias_cross are [B, 1, L, L], bias_full [B, 1, 1, L].

    - chunk: text rows see chunk-internal text and real image regions; image
      rows see only real image regions;
    - full: plain padding mask;
    - cross: text rows as in the chunk stage; image rows see only themselves,
      padded regions included.
    """
    B, T = text_mask.shape
    I = img_mask.shape[1]
    dev = text_mask.device
    text_mask = text_mask.float()
    img_mask = img_mask.float()
    chunk_mask = chunk_mask.float()

    img_col = ((1.0 - img_mask) * NEG_INF)[:, None, :]          # [B, 1, I]
    chunk_bias = (1.0 - chunk_mask) * NEG_INF                    # [B, T, T]
    text_rows = torch.cat([chunk_bias, img_col.expand(B, T, I)], dim=-1)

    hard = torch.full((B, I, T), NEG_INF, device=dev)
    img_rows_chunk = torch.cat([hard, img_col.expand(B, I, I)], dim=-1)
    bias_chunk = torch.cat([text_rows, img_rows_chunk], dim=1)[:, None]

    full_mask = torch.cat([text_mask, img_mask], dim=-1)
    bias_full = ((1.0 - full_mask) * NEG_INF)[:, None, None, :]

    eye_bias = (1.0 - torch.eye(I, device=dev)) * NEG_INF        # [I, I]
    img_rows_cross = torch.cat([hard, eye_bias[None].expand(B, I, I)], dim=-1)
    bias_cross = torch.cat([text_rows, img_rows_cross], dim=1)[:, None]
    return bias_chunk, bias_full, bias_cross
