"""Prefix-injected RoBERTa reasoner (port of the JAX package's
``models/roberta.py``, its non-scan, non-remat path).

Each attention layer projects the raw prefix vectors through its own key and
value weights and prepends them to the token K/V stream; queries come only
from real tokens, so sequence length, position ids and the pooler are
untouched.  Every layer runs the stage-mask attention in the "full" stage
over the prefixed KV stream.  ``scan_layers`` and ``remat`` only shape the
JAX program; interop/from_jax.py unstacks a scanned parameter tree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import EncoderConfig, RobertaConfig
from multimodal_context_reasoning_torch.models.layers import (
    BertEmbeddings,
    Pooler,
    TransformerLayer,
)
from multimodal_context_reasoning_torch.ops.masks import full_mask_spec, padding_bias


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """HF RoBERTa position ids: cumsum over non-pad, offset by pad_token_id."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def encoder_config(c: RobertaConfig) -> EncoderConfig:
    """The reasoner's layers as an EncoderConfig."""
    return EncoderConfig(
        vocab_size=c.vocab_size,
        hidden_size=c.hidden_size,
        num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        intermediate_size=c.intermediate_size,
        hidden_act=c.hidden_act,
        hidden_dropout_prob=c.hidden_dropout_prob,
        attention_probs_dropout_prob=c.attention_probs_dropout_prob,
        max_position_embeddings=c.max_position_embeddings,
        type_vocab_size=c.type_vocab_size,
        initializer_range=c.initializer_range,
        layer_norm_eps=c.layer_norm_eps,
        pad_token_id=c.pad_token_id,
        dtype=c.dtype,
    )


class RobertaOutput(NamedTuple):
    sequence: torch.Tensor   # [B, L, H]
    pooled: torch.Tensor     # [B, H]


class PrefixRoberta(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.config = c
        ec = encoder_config(c)
        self.embeddings = BertEmbeddings(ec)
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            TransformerLayer(ec) for _ in range(c.num_hidden_layers)
        )})
        self.pooler = Pooler(c.hidden_size)

    def forward(
        self,
        input_ids: torch.Tensor,                          # [B, L]
        attention_mask: torch.Tensor,                     # [B, L] {0,1}
        token_type_ids: Optional[torch.Tensor] = None,
        prompt_embeddings: Optional[torch.Tensor] = None,  # [B, P, H]
        prompt_mask: Optional[torch.Tensor] = None,        # [B, P] {0,1}
    ) -> RobertaOutput:
        c = self.config
        pos_ids = roberta_position_ids(input_ids, c.pad_token_id)
        h = self.embeddings(input_ids, token_type_ids, pos_ids)

        kv_valid = attention_mask.float()
        if prompt_embeddings is not None:
            if prompt_mask is None:
                prompt_mask = torch.ones(prompt_embeddings.shape[:2],
                                         device=input_ids.device)
            kv_valid = torch.cat([prompt_mask.float(), kv_valid], dim=-1)
        bias = padding_bias(kv_valid)  # taken only under attention dropout
        spec = full_mask_spec(kv_valid, input_ids.shape[1])
        for layer in self.encoder.layer:
            h, _ = layer(h, bias, prefix_kv=prompt_embeddings, mask_spec=spec)
        return RobertaOutput(sequence=h, pooled=self.pooler(h))
