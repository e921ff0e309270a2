"""Shared transformer building blocks (port of the JAX package's
``models/layers.py``).

Module and parameter names follow the reference's HuggingFace layout
(``attention.self.query``, ``attention.output.LayerNorm``,
``intermediate.dense``, ``output.dense`` ...), so the port's state dict has
exactly the keys of ``interop/export.py:export_modcr_state_dict`` and a
reference checkpoint loads with ``strict=True``.

Numerics follow the JAX package, not the original PyTorch repo:

- ``hidden_act="gelu"`` is flax's default gelu, the tanh form
  (``F.gelu(x, approximate="tanh")``);
- a layer computes in the dtype of its weights (the scorer casts them to
  the config's compute dtype once); ``nn.LayerNorm`` on bf16 accumulates
  its statistics in fp32, as flax's does;
- attention with a :class:`MaskSpec` that needs neither probabilities nor
  dropout goes to ``fused_attention_spec`` (the CUDA kernel on a CUDA
  tensor, its plain version on a CPU tensor); everything else goes to the
  plain ``dot_product_attention`` with the dense -10000 bias.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_context_reasoning_torch.core.config import EncoderConfig
from multimodal_context_reasoning_torch.ops.attention import dot_product_attention
from multimodal_context_reasoning_torch.ops.chunk import chunk_mean_scatter
from multimodal_context_reasoning_torch.ops.masks import MaskSpec
from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec

def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax's default ``nn.gelu`` (approximate=True), HF's "gelu_new"."""
    return F.gelu(x, approximate="tanh")


ACT = {"gelu": gelu_tanh, "gelu_new": gelu_tanh, "relu": F.relu, "tanh": torch.tanh}


class Linear(nn.Linear):
    """``nn.Linear`` that casts its input to the weights' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings, LayerNorm, dropout.
    RoBERTa's position ids come from the caller."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        B, T = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(T, device=input_ids.device)[None].expand(B, T)
        x = (self.word_embeddings(input_ids) + self.token_type_embeddings(token_type_ids)
             + self.position_embeddings(position_ids))
        return self.dropout(self.LayerNorm(x))


class SelfAttention(nn.Module):
    """Post-LN BERT self-attention with the prefix-KV and chunk-mean-query
    hooks (``attention.self.*`` and ``attention.output.*``)."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.config = c
        D = c.hidden_size
        self.self = nn.ModuleDict(
            {"query": Linear(D, D), "key": Linear(D, D), "value": Linear(D, D)}
        )
        self.output = nn.ModuleDict(
            {"dense": Linear(D, D), "LayerNorm": nn.LayerNorm(D, eps=c.layer_norm_eps)}
        )
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(
        self,
        hidden: torch.Tensor,                         # [B, L, D]
        bias: Optional[torch.Tensor],                 # broadcastable [B, H, L, P+L]
        *,
        prefix_kv: Optional[torch.Tensor] = None,     # [B, P, D] raw hidden vectors
        chunk_query_index: Optional[torch.Tensor] = None,  # [B, L] ids, -1 = keep
        num_chunks: int = 0,
        mask_spec: Optional[MaskSpec] = None,
        return_probs: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        c = self.config
        H, Dh = c.num_attention_heads, c.head_dim
        q = self.self.query(hidden)
        kv_src = hidden
        if prefix_kv is not None:
            # prefix states projected through this layer's own K/V weights
            kv_src = torch.cat([prefix_kv.to(hidden.dtype), hidden], dim=1)
        k = self.self.key(kv_src)
        v = self.self.value(kv_src)
        if chunk_query_index is not None:
            # chunk-mean rewrite of the projected queries, before the head split
            q = chunk_mean_scatter(q, chunk_query_index, num_chunks)

        B, L, _ = hidden.shape
        Lk = kv_src.shape[1]
        q = q.view(B, L, H, Dh)
        k = k.view(B, Lk, H, Dh)
        v = v.view(B, Lk, H, Dh)

        needs_dropout = self.training and c.attention_probs_dropout_prob > 0.0
        if mask_spec is not None and not return_probs and not needs_dropout:
            out = fused_attention_spec(
                q, k, v, mask_spec.valid, mask_spec.gi, mask_spec.rowfull,
                stage=mask_spec.stage, text_len=mask_spec.text_len,
            )
            probs = None
        else:
            if bias is None:
                raise ValueError("the plain attention path needs a dense bias")
            out, probs = dot_product_attention(
                q, k, v, bias,
                dropout_rate=c.attention_probs_dropout_prob,
                training=self.training, return_probs=return_probs,
            )
        out = self.dropout(self.output.dense(out.reshape(B, L, c.hidden_size)))
        return self.output.LayerNorm(out + hidden), probs


class FeedForward(nn.Module):
    """BertIntermediate + BertOutput: dense-act-dense, dropout, residual, LN
    (``intermediate.dense``, ``output.dense``, ``output.LayerNorm``).  The
    layers that own an FFN subclass it, so its keys sit at their level as
    in the reference."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.act = ACT[c.hidden_act]
        self.intermediate = nn.ModuleDict(
            {"dense": Linear(c.hidden_size, c.intermediate_size)}
        )
        self.output = nn.ModuleDict({
            "dense": Linear(c.intermediate_size, c.hidden_size),
            "LayerNorm": nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps),
        })
        self.ffn_dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.intermediate.dense(x))
        h = self.ffn_dropout(self.output.dense(h))
        return self.output.LayerNorm(h + x)


class TransformerLayer(FeedForward):
    """One post-LN encoder layer: self-attention, then the FFN."""

    def __init__(self, c: EncoderConfig):
        super().__init__(c)
        self.attention = SelfAttention(c)

    def forward(self, hidden, bias, **attn_kwargs):
        attn_out, probs = self.attention(hidden, bias, **attn_kwargs)
        return super().forward(attn_out), probs


class Pooler(nn.Module):
    """tanh(dense(h[:, 0])) — BertPooler."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))
