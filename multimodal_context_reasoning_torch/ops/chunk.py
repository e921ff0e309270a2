"""Chunk-mean query rewrite and the chunk-block mask.

Port of the JAX package's ``ops/chunk.py``.  ``gather_index[b, t]`` is the
chunk id of text position ``t`` (over the full stream including CLS), or -1
for positions outside any chunk (CLS, SEPs, padding), which keep their own
vector.
"""

from __future__ import annotations

import torch


def chunk_mean_scatter(x: torch.Tensor, gather_index: torch.Tensor,
                       num_chunks: int) -> torch.Tensor:
    """Replace each in-chunk token vector of ``x`` [B, T, D] with its chunk
    mean, as two products with the one-hot chunk assignment [B, T, C]."""
    assigned = gather_index >= 0
    ids = torch.arange(num_chunks, dtype=gather_index.dtype, device=x.device)
    onehot = ((gather_index[..., None] == ids) & assigned[..., None]).to(x.dtype)
    counts = onehot.sum(dim=1)                                   # [B, C]
    sums = torch.einsum("btc,btd->bcd", onehot, x)
    means = sums / torch.clamp(counts, min=1.0)[..., None]
    gathered = torch.einsum("btc,bcd->btd", onehot, means)
    return torch.where(assigned[..., None], gathered, x)


def chunk_mask_from_gather_index(gather_index: torch.Tensor,
                                 text_mask: torch.Tensor) -> torch.Tensor:
    """[B, T, T] fp32 chunk-block mask: same-chunk tokens see each other,
    every real token sees itself, the CLS row and the last-real-token row
    see everything (rows only), and padding sees nothing."""
    T = gather_index.shape[1]
    dev = gather_index.device
    same_chunk = ((gather_index[:, :, None] == gather_index[:, None, :])
                  & (gather_index[:, :, None] >= 0))
    eye = torch.eye(T, dtype=torch.bool, device=dev)[None]
    pos = torch.arange(T, device=dev)[None, :]
    lengths = (text_mask > 0).sum(dim=1)
    cls_or_sep = (pos == 0) | (pos == (lengths - 1)[:, None])
    full_rows = cls_or_sep[:, :, None]
    real = (text_mask[:, :, None] > 0) & (text_mask[:, None, :] > 0)
    return ((same_chunk | full_rows | eye) & real).float()
