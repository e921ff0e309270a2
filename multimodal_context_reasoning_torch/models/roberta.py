"""Prefix-injected RoBERTa reasoner (port of the JAX package's
``models/roberta.py``).

Each attention layer projects the raw prefix vectors through its own key and
value weights and prepends them to the token K/V stream; queries come only
from real tokens, so sequence length, position ids and the pooler are
untouched.  Two branches, as in the JAX package (roberta.py:144-202):

- the default one gives every layer the "full"-stage :class:`MaskSpec` over
  the prefixed KV stream, so attention runs the stage-mask attention;
- with ``remat`` or ``scan_layers`` every layer gets the dense padding bias
  [B, 1, 1, P + L] (-10000 on masked slots) and no mask spec, so attention
  runs the dense-bias ``mem_efficient_attention``.  Under ``remat`` each
  layer runs inside ``torch.utils.checkpoint`` (non-reentrant, the RNG state
  kept so dropout masks replay): policy "full" recomputes everything in the
  backward, "dots" saves the outputs of the matrix products without batch
  dimensions (the projections and the FFN), as JAX's
  ``dots_with_no_batch_dims_saveable`` does.  ``scan_layers`` only changes
  the JAX parameter layout, which interop/from_jax.py unstacks; here it runs
  the same loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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
        quantize=c.quantize,
    )


# matrix products without batch dimensions: what "dots" saves under remat
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _run_layer(layer, h, bias, prefix_kv):
    return layer(h, bias, prefix_kv=prefix_kv)[0]


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
        self.pooler = Pooler(c.hidden_size, c.torch_dtype)

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
        bias = padding_bias(kv_valid)
        if c.remat or c.scan_layers:
            remat = c.remat and torch.is_grad_enabled()
            context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                            _dots_policy)
                          if c.remat_policy == "dots" else None)
            for layer in self.encoder.layer:
                if remat:
                    kw = {"context_fn": context_fn} if context_fn else {}
                    h = checkpoint(_run_layer, layer, h, bias, prompt_embeddings,
                                   use_reentrant=False, **kw)
                else:
                    h = _run_layer(layer, h, bias, prompt_embeddings)
        else:
            # the dense bias is taken here only under attention dropout
            spec = full_mask_spec(kv_valid, input_ids.shape[1])
            for layer in self.encoder.layer:
                h, _ = layer(h, bias, prefix_kv=prompt_embeddings, mask_spec=spec)
        return RobertaOutput(sequence=h, pooled=self.pooler(h))
