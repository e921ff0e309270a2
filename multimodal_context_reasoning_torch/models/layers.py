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
- parameters are fp32 and every :class:`Linear`, :class:`Embedding` and
  :class:`LayerNorm` computes in its config's ``torch_dtype``, as flax's
  ``Dense(dtype=bf16)`` does over fp32 params: the input and the weights are
  cast to that dtype in the forward (a no-op for weights the scorer has
  already cast), and LayerNorm normalises in fp32;
- a tower whose config says ``quantize="int8"`` sends exactly the products
  the JAX package quantizes (``_dense``, layers.py:43-50: query, key, value,
  the attention output and the FFN's two) through the W8A8 route of
  ``ops/quant.py``; the parameters and the state dict do not change;
- under tensor parallelism (parallel/partition.py::shard_module_) a
  :class:`Linear` holds a block of output features (``tp_mode="col"``) or
  of input features (``"row"``: its partial products are summed over
  ``tp_group`` before the whole bias is added), and attention takes its
  local head count from the local projection width, so the modules stay
  mesh-agnostic.  A layer asked for its probabilities returns them summed
  over all heads, [B, 1, L, Lk]: their one consumer, the alignment loss,
  sums over heads;
- attention takes the JAX package's dispatch (layers.py:136-188) with
  "use_pallas" read as "a CUDA tensor".  A call that needs neither
  probabilities nor dropout goes to ``fused_attention_spec`` when it has a
  :class:`MaskSpec`, and to the dense-bias ``mem_efficient_attention``
  otherwise: on a CUDA tensor their kernels, forward and backward, on a CPU
  tensor their plain versions.  Everything else goes to the plain
  ``dot_product_attention`` with the dense -10000 bias.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_context_reasoning_torch.core.config import EncoderConfig
from multimodal_context_reasoning_torch.ops.attention import dot_product_attention
from multimodal_context_reasoning_torch.ops.chunk import chunk_mean_scatter
from multimodal_context_reasoning_torch.ops.flash import mem_efficient_attention
from multimodal_context_reasoning_torch.ops.masks import MaskSpec
from multimodal_context_reasoning_torch.ops.quant import int8_matmul, quantize_symmetric
from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec
from multimodal_context_reasoning_torch.parallel.comm import copy_to_group, reduce_from_group
from multimodal_context_reasoning_torch.utils.profiling import count


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax's default ``nn.gelu`` (approximate=True), HF's "gelu_new"."""
    return F.gelu(x, approximate="tanh")


ACT = {"gelu": gelu_tanh, "gelu_new": gelu_tanh, "relu": F.relu, "tanh": torch.tanh}


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``Dense(dtype=)``):
    input, weight and bias are cast to it.

    With ``quantize`` it is the JAX package's ``QuantDense`` instead:
    ``int8_matmul`` of the input as it comes, the weight quantized per
    output channel from the dtype the module holds it in (fp32 in a model,
    as the JAX package quantizes its fp32 params; the scorer's compute
    dtype once the scorer has cast it, bf16 at full width, as the JAX
    scorer with ``params_dtype="bfloat16"``), and the output in
    ``compute_dtype``.  :meth:`freeze_int8` quantizes the weight once into
    non-persistent buffers, the same bits as quantizing per call, for
    weights that no longer change.

    ``tp_mode`` / ``tp_group`` are set by ``shard_module_`` (see the module
    docstring); an int8 row-parallel product takes its scales' amax over
    the group and sums the int32 accumulators, the JAX arithmetic."""

    tp_mode: Optional[str] = None
    tp_group = None

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32, quantize: bool = False):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        self.quantize = quantize
        self.register_buffer("int8_codes", None, persistent=False)
        self.register_buffer("int8_scale", None, persistent=False)

    @property
    def _row_group(self):
        return self.tp_group if self.tp_mode == "row" else None

    @torch.no_grad()
    def freeze_int8(self) -> None:
        self.int8_codes, self.int8_scale = quantize_symmetric(self.weight, dim=1,
                                                              group=self._row_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp_mode == "col":
            x = copy_to_group(x, self.tp_group)
        if self.quantize:
            frozen = None if self.int8_codes is None else (self.int8_codes, self.int8_scale)
            return int8_matmul(x, self.weight, self.bias, dt, weight_q=frozen,
                               group=self._row_group)
        if self.tp_mode == "row":
            y = reduce_from_group(F.linear(x.to(dt), self.weight.to(dt)), self.tp_group)
            return y + self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def freeze_int8(model: nn.Module) -> nn.Module:
    """Quantize the weights of every int8 :class:`Linear` of ``model`` once
    (:meth:`Linear.freeze_int8`); inference only: a later change of the
    weights is not seen."""
    for m in model.modules():
        if isinstance(m, Linear) and m.quantize:
            m.freeze_int8()
    return model


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose rows come out in ``compute_dtype`` (flax
    ``Embed(dtype=)``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, embedding_dim)
        self.compute_dtype = compute_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with its output in ``compute_dtype`` (flax
    ``LayerNorm(dtype=)``).  Over fp32 parameters it normalises and applies
    the affine in fp32 and rounds the result once, as flax does; over
    parameters already in the compute dtype (the bf16 scorer) it is
    PyTorch's LayerNorm in that dtype, whose statistics are fp32."""

    def __init__(self, normalized_shape: int, eps: float,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.weight.dtype == dt:
            return super().forward(x.to(dt))
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(dt)


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings, LayerNorm, dropout.
    RoBERTa's position ids come from the caller."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        dt = c.torch_dtype
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, dt)
        self.position_embeddings = Embedding(c.max_position_embeddings, c.hidden_size, dt)
        self.token_type_embeddings = Embedding(c.type_vocab_size, c.hidden_size, dt)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dt)
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
    hooks (``attention.self.*`` and ``attention.output.*``).  ``head_group``
    is the model group of a sharded layer (the probabilities' head sum)."""

    head_group = None

    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.config = c
        D, dt, q8 = c.hidden_size, c.torch_dtype, c.quantize == "int8"
        self.self = nn.ModuleDict({name: Linear(D, D, dt, q8)
                                   for name in ("query", "key", "value")})
        self.output = nn.ModuleDict(
            {"dense": Linear(D, D, dt, q8), "LayerNorm": LayerNorm(D, c.layer_norm_eps, dt)}
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
        Dh = c.head_dim
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
        # the local heads (all of them unless the projections are sharded)
        q = q.view(B, L, -1, Dh)
        k = k.view(B, Lk, -1, Dh)
        v = v.view(B, Lk, -1, Dh)

        needs_dropout = self.training and c.attention_probs_dropout_prob > 0.0
        probs = None
        if mask_spec is not None and not return_probs and not needs_dropout:
            out = fused_attention_spec(
                q, k, v, mask_spec.valid, mask_spec.gi, mask_spec.rowfull,
                stage=mask_spec.stage, text_len=mask_spec.text_len,
            )
        elif not return_probs and not needs_dropout:
            out = mem_efficient_attention(q, k, v, bias)
        else:
            if bias is None:
                raise ValueError("the plain attention path needs a dense bias")
            count("attention.plain.probs" if return_probs else "attention.plain.dropout")
            out, probs = dot_product_attention(
                q, k, v, bias,
                dropout_rate=c.attention_probs_dropout_prob,
                training=self.training, return_probs=return_probs,
            )
        if probs is not None and self.head_group is not None:
            probs = reduce_from_group(probs.sum(1, keepdim=True), self.head_group)
        out = self.dropout(self.output.dense(out.reshape(B, L, -1)))
        return self.output.LayerNorm(out + hidden), probs


class FeedForward(nn.Module):
    """BertIntermediate + BertOutput: dense-act-dense, dropout, residual, LN
    (``intermediate.dense``, ``output.dense``, ``output.LayerNorm``).  The
    layers that own an FFN subclass it, so its keys sit at their level as
    in the reference."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        dt, q8 = c.torch_dtype, c.quantize == "int8"
        self.act = ACT[c.hidden_act]
        self.intermediate = nn.ModuleDict(
            {"dense": Linear(c.hidden_size, c.intermediate_size, dt, q8)}
        )
        self.output = nn.ModuleDict({
            "dense": Linear(c.intermediate_size, c.hidden_size, dt, q8),
            "LayerNorm": LayerNorm(c.hidden_size, c.layer_norm_eps, dt),
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

    def __init__(self, hidden_size: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, compute_dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))
