"""CALeC fusion: multi-view CLS reasoning over the chunk-aligned memory
(port of the JAX package's ``models/fusion.py``).

- fuse the two encoders' CLS vectors through ``cls_ensemble_1``;
- build the 3×(T-1) memory ``[global_hypo ‖ chunk_align ‖ chunk_hidden]``;
- run ``cls_layer_num`` :class:`ClsLayerLyx` layers: single-query multi-head
  cross-attention of the fused CLS over the memory, then the BERT FFN;
- the alignment loss from the last three cross-modal attention maps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_context_reasoning_torch.core.config import ChunkAlignConfig, EncoderConfig
from multimodal_context_reasoning_torch.models.layers import FeedForward, LayerNorm, Linear
from multimodal_context_reasoning_torch.ops.attention import dot_product_attention
from multimodal_context_reasoning_torch.ops.masks import padding_bias


class ClsLayerLyx(FeedForward):
    """Single-query multi-head cross-attention + FFN (ClsLayer_lyx).  Keys:
    ``cross_attention.{q,k,v,out}_proj``, ``LayerNorm`` and the FFN's.

    The production path (temperature 1, no inverted attention, no prior)
    runs :func:`dot_product_attention`.  ``cross_attention_lyx``'s other
    options take an explicit path: scores over sqrt(Dh) plus the bias,
    divided by ``tau``, softmax, ``1 - p`` under ``neg_type``, ``+
    prior_score``, then dropout."""

    def __init__(self, c: EncoderConfig, num_heads: int = 8, *, tau: float = 1.0,
                 neg_type: bool = False):
        super().__init__(c)
        self.config = c
        self.num_heads = num_heads
        self.tau = tau
        self.neg_type = neg_type
        D, dt = c.hidden_size, c.torch_dtype
        self.cross_attention = nn.ModuleDict(
            {name: Linear(D, D, dt) for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
        )
        self.LayerNorm = LayerNorm(D, c.layer_norm_eps, dt)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(
        self,
        memory: torch.Tensor,                   # [B, M, D]
        cls: torch.Tensor,                      # [B, D]
        memory_bias: Optional[torch.Tensor],    # [B, 1, 1, M] additive or None
        prior_score: Optional[torch.Tensor] = None,   # [B, 1, M] added to probs
    ) -> torch.Tensor:
        c = self.config
        Dh = c.hidden_size // self.num_heads
        B, M, _ = memory.shape
        att = self.cross_attention
        # the local heads: all of them unless the projections are sharded
        q = att.q_proj(cls[:, None, :]).view(B, 1, -1, Dh)
        k = att.k_proj(memory).view(B, M, -1, Dh)
        v = att.v_proj(memory).view(B, M, -1, Dh)
        drop = c.attention_probs_dropout_prob
        if self.tau != 1.0 or self.neg_type or prior_score is not None:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / Dh ** 0.5
            if memory_bias is not None:
                scores = scores + memory_bias.float()
            probs = torch.softmax(scores / self.tau, dim=-1)
            if self.neg_type:
                probs = 1.0 - probs
            if prior_score is not None:
                probs = probs + prior_score[:, None].float()
            probs = F.dropout(probs, drop, training=self.training)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        else:
            out, _ = dot_product_attention(q, k, v, memory_bias, dropout_rate=drop,
                                           training=self.training)
        out = self.dropout(att.out_proj(out.reshape(B, 1, -1))[:, 0])
        h = self.LayerNorm(out + cls)
        return super().forward(h[:, None, :])[:, 0]


def alignment_loss_from_probs(seq_attn_probs: torch.Tensor, text_len: int,
                              align_pos: Optional[torch.Tensor],
                              total_label: Optional[torch.Tensor]):
    """Attention-alignment CE: sum the last three cross-modal maps over
    layers and heads, take the text->image block, re-mask exact zeros,
    softmax, and score that softmax as logits of a second log-softmax at the
    ``<|det#|>`` positions (the reference's CrossEntropyLoss on it).

    Returns ``(align_loss scalar fp32, align_logits [B, T, I])``."""
    T = text_len
    attn_sum = seq_attn_probs[:, -3:].sum(dim=(1, 2))            # [B, L, L]
    attn_ti = attn_sum[:, :T, T:]
    attn_ti = torch.where(attn_ti == 0.0, torch.full_like(attn_ti, -1e5), attn_ti)
    align_logits = torch.softmax(attn_ti, dim=-1)

    align_loss = torch.zeros((), device=attn_ti.device)
    if align_pos is not None and total_label is not None:
        logp = F.log_softmax(align_logits, dim=-1)
        tgt = torch.clamp(total_label.long(), 0, attn_ti.shape[-1] - 1)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        w = align_pos.float()
        align_loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    return align_loss, align_logits


class FusionOutput(NamedTuple):
    cls_ensem: torch.Tensor                 # [B, D] fused multi-view CLS
    align_loss: torch.Tensor                # scalar
    align_logits: torch.Tensor              # [B, T, I]


class ChunkAlignFusion(nn.Module):
    """``cls_ensemble_1`` and the ``cls_layer_lyx`` stack.  In the composite
    model this module is ``calec`` and also carries the two encoders, as
    the reference's ChunkAlign_CLS_enc4_align_ensemble does."""

    def __init__(self, c: EncoderConfig, schedule: ChunkAlignConfig):
        super().__init__()
        self.schedule = schedule
        self.cls_ensemble_1 = Linear(2 * c.hidden_size, c.hidden_size, c.torch_dtype)
        self.cls_layer_lyx = nn.ModuleList(
            ClsLayerLyx(c, schedule.cls_num_heads) for _ in range(schedule.cls_layer_num)
        )

    def forward(
        self,
        global_seq: torch.Tensor,       # [B, T+I, D]
        global_cls: torch.Tensor,       # [B, D]
        seq_seq: torch.Tensor,          # [B, T+I, D]
        seq_cls: torch.Tensor,          # [B, D]
        chunk_hidden: torch.Tensor,     # [B, T+I, D]
        seq_attn_probs: Optional[torch.Tensor],  # [B, 3, H, L, L]; None skips
        text_mask: torch.Tensor,        # [B, T]
        text_len: int,
        align_pos: Optional[torch.Tensor] = None,
        total_label: Optional[torch.Tensor] = None,
    ) -> FusionOutput:
        T = text_len
        cls_ensem = self.cls_ensemble_1(torch.cat([global_cls, seq_cls], dim=-1))
        memory = torch.cat(
            [global_seq[:, 1:T], seq_seq[:, 1:T], chunk_hidden[:, 1:T]], dim=1
        )
        memory_bias = None
        if self.schedule.mask_fusion_memory:
            word = text_mask[:, 1:T]
            memory_bias = padding_bias(torch.cat([word, word, word], dim=-1))

        for layer in self.cls_layer_lyx:
            cls_ensem = layer(memory, cls_ensem, memory_bias)

        if seq_attn_probs is None:
            B, L = global_seq.shape[:2]
            return FusionOutput(
                cls_ensem, torch.zeros((), device=global_seq.device),
                torch.zeros((B, T, L - T), device=global_seq.device),
            )
        align_loss, align_logits = alignment_loss_from_probs(
            seq_attn_probs, T, align_pos, total_label
        )
        return FusionOutput(cls_ensem, align_loss, align_logits)
