"""Plain multi-head attention with an additive bias.

Port of the JAX package's ``ops/attention.py:dot_product_attention``.  It is
the path that returns attention probabilities (the alignment loss, the CALeC
fusion layers), the path under attention dropout, and the oracle of the
stage-mask kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def dot_product_attention(
    q: torch.Tensor,                       # [B, Lq, H, Dh]
    k: torch.Tensor,                       # [B, Lk, H, Dh]
    v: torch.Tensor,                       # [B, Lk, H, Dh]
    bias: Optional[torch.Tensor] = None,   # broadcastable to [B, H, Lq, Lk]
    *,
    dropout_rate: float = 0.0,
    training: bool = False,
    return_probs: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scores scaled by 1/sqrt(Dh) in the inputs' dtype, bias added and
    softmax taken in fp32, optional dropout on the probabilities, PV in v's
    dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)

    attn = F.dropout(probs, dropout_rate, training=training)

    out = torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype), v)
    return out, (probs if return_probs else None)
