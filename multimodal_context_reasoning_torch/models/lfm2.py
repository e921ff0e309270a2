"""The LFM2 mixture-of-experts reasoner (LiquidAI LFM2-8B-A1B), ModCR's
second reasoner (``ModCRConfig.reasoner == "lfm2_moe"``): the mapped
10-vector prefix enters as the first input embeddings, the row's tokens
follow, and the score reads the last valid token's state after the final
RMSNorm.

Equations (the dense model as transformers' ``models/lfm2/
modeling_lfm2.py`` computes it; the MoE as LFM2-8B-A1B's ``config.json``
describes it), for hidden states h [B, L, D]:

- layer: ``x = h + op(RMSNorm_op(h))``, ``out = x + ffn(RMSNorm_ffn(x))``;
  ``embedding_norm`` after the last layer;
- ``RMSNorm(x) = w ⊙ x·rsqrt(mean(x²) + eps)``, in fp32, rounded once to
  the compute dtype;
- conv op: ``B, C, x = split₃(in_proj(h))``, ``y = C ⊙ dwconv(B ⊙ x)``
  with a causal depthwise convolution over the sequence (kernel
  ``conv_L_cache``, left-padded, no bias), then ``out_proj(y)``;
- attention op: q, k, v projections, per-head RMSNorm on q and k, RoPE
  (``rope_theta``) over positions 0..L-1, causal softmax attention with
  each KV head shared by H / H_kv query heads, ``out_proj``.  It runs on
  the dense-bias attention op (ops/fused_attention.py; its kernel on a
  card) with the KV heads expanded and one fp32 [B, 1, L, L] bias, causal
  plus key padding at -10000;
- dense FFN (the first ``num_dense_layers``): ``w2(silu(w1 x) ⊙ w3 x)``;
- sparse MoE (the rest): ``s = sigmoid(gate(x))`` in fp32; the top
  ``num_experts_per_tok`` of ``s + expert_bias`` (the bias selects and
  does not weigh); weights ``s_sel / (Σ s_sel + 1e-6)`` with
  ``norm_topk_prob``, times ``routed_scaling_factor``; ``out = Σ weight_e
  · expert_e(x)`` over the chosen experts.  No token is dropped.

Routing makes no host synchronisation on a bf16 card tensor, so the
forward stays inside ``eval_step``'s captured graphs (train/graphs.py):
the (token, slot) pairs are sorted by expert on the device, the experts'
offsets come from a ``scatter_add_`` and a ``cumsum``, the three expert
products run as two grouped products (``torch._grouped_mm``: gate and up
stacked, then down) whose offsets stay on the device, and the rows come
back by an index copy and a sum over the slots, in a fixed order.
Anywhere else (the CPU, fp32) the layer runs :func:`looped_experts`, the
plain per-expert loop that is also the oracle of the grouped route.

Parameter names are the published checkpoint's (``embed_tokens``,
``layers.{i}.{operator_norm,ffn_norm}``, ``layers.{i}.conv.{in_proj,
conv,out_proj}``, ``layers.{i}.self_attn.{q,k,v,out}_proj`` and
``{q,k}_layernorm``, ``layers.{i}.feed_forward.{w1,w2,w3}`` or
``feed_forward.{gate,expert_bias,experts.{e}.w1,...}``,
``embedding_norm``).  Products go through the port's :class:`Linear`
(the compute dtype over fp32 parameters).

Spans: ``reasoner.conv``, ``reasoner.attention``, ``reasoner.moe.route``,
``reasoner.moe.experts``; counters ``reasoner.conv.layers``,
``reasoner.attention.layers``, ``moe.layers`` (one per layer call).  While
spans are on, each MoE layer adds its experts' token counts into the
device tally :data:`EXPERT_TALLY` (utils/profiling.py::tally), row by MoE
layer.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_context_reasoning_torch.core.config import Lfm2MoeConfig
from multimodal_context_reasoning_torch.models.layers import Embedding, Linear
from multimodal_context_reasoning_torch.ops.flash import mem_efficient_attention
from multimodal_context_reasoning_torch.utils.profiling import count, span, tally

NEG = -10000.0
ROUTE_EPS = 1e-6            # the weights' denominator: Σ s_sel + ROUTE_EPS
EXPERT_TALLY = "moe.expert_tokens"


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, compute_dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps, self.compute_dtype = eps, compute_dtype

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """The norm in fp32, not rounded."""
        x = x.float()
        return self.weight.float() * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalize(x).to(self.compute_dtype)


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y[:, t] = Σ_j w[:, j] · x[:, t + j - (K - 1)]`` over x [B, L, D] and
    w [D, K], zeros before the first position (``nn.Conv1d(groups=D,
    padding=K - 1)`` cut to L), as K shifted products in x's dtype."""
    K = w.shape[1]
    y = x * w[:, K - 1]
    for s in range(1, min(K, x.shape[1])):
        y[:, s:] += x[:, :-s] * w[:, K - 1 - s]
    return y


class ShortConv(nn.Module):
    def __init__(self, c: Lfm2MoeConfig):
        super().__init__()
        d, dt = c.hidden_size, c.torch_dtype
        self.in_proj = Linear(d, 3 * d, dt, bias=False)
        # held as the published Conv1d for its parameter's name and shape
        # [D, 1, K]; :func:`causal_depthwise_conv` computes it
        self.conv = nn.Conv1d(d, d, c.conv_L_cache, groups=d, bias=False,
                              padding=c.conv_L_cache - 1)
        self.out_proj = Linear(d, d, dt, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, gate, x = self.in_proj(h).chunk(3, dim=-1)
        y = causal_depthwise_conv(b * x, self.conv.weight[:, 0].to(x.dtype))
        return self.out_proj(gate * y)


def rope_tables(length: int, dh: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [L, Dh] (fp32) of positions 0..L-1, the frequencies
    repeated over the two halves of a head."""
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=device, dtype=torch.float32) / dh)
    freqs = torch.arange(length, device=device, dtype=torch.float32)[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, H, Dh] rotated by position (the rotate-half form)."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos[:, None] + torch.cat([-x2, x1], dim=-1) * sin[:, None]


def causal_padding_bias(valid: torch.Tensor) -> torch.Tensor:
    """[B, 1, L, L] fp32: 0 where key j <= query i and key j is valid,
    -10000 elsewhere (valid [B, L] in {0, 1})."""
    L = valid.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool, device=valid.device).tril()
    keep = causal[None] & (valid[:, None, :] > 0)
    return ((~keep).float() * NEG)[:, None]


class Attention(nn.Module):
    def __init__(self, c: Lfm2MoeConfig):
        super().__init__()
        d, dt, dh = c.hidden_size, c.torch_dtype, c.head_dim
        self.heads, self.kv_heads, self.dh, self.dtype = (c.num_attention_heads,
                                                          c.num_key_value_heads, dh, dt)
        self.q_proj = Linear(d, self.heads * dh, dt, bias=False)
        self.k_proj = Linear(d, self.kv_heads * dh, dt, bias=False)
        self.v_proj = Linear(d, self.kv_heads * dh, dt, bias=False)
        self.out_proj = Linear(self.heads * dh, d, dt, bias=False)
        self.q_layernorm = RMSNorm(dh, c.norm_eps, dt)
        self.k_layernorm = RMSNorm(dh, c.norm_eps, dt)

    def forward(self, h, cos, sin, bias) -> torch.Tensor:
        B, L, _ = h.shape
        rep = self.heads // self.kv_heads
        q = self.q_proj(h).view(B, L, self.heads, self.dh)
        k = self.k_proj(h).view(B, L, self.kv_heads, self.dh)
        v = self.v_proj(h).view(B, L, self.kv_heads, self.dh)
        q = apply_rope(self.q_layernorm.normalize(q), cos, sin).to(self.dtype)
        k = apply_rope(self.k_layernorm.normalize(k), cos, sin).to(self.dtype)
        # query head i reads KV head i // rep
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        out = mem_efficient_attention(q, k, v, bias)
        return self.out_proj(out.reshape(B, L, self.heads * self.dh))


class SwiGLU(nn.Module):
    """``w2(silu(w1 x) ⊙ w3 x)``: the dense FFN and each expert."""

    def __init__(self, d: int, f: int, dt: torch.dtype):
        super().__init__()
        self.w1 = Linear(d, f, dt, bias=False)
        self.w3 = Linear(d, f, dt, bias=False)
        self.w2 = Linear(f, d, dt, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def looped_experts(x: torch.Tensor, sel: torch.Tensor, weight: torch.Tensor,
                   experts) -> torch.Tensor:
    """The MoE's output [T, D] in x's dtype, one expert at a time: each
    expert's tokens gathered, run, weighted and added back in fp32."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e, expert in enumerate(experts):
        tok, slot = (sel == e).nonzero(as_tuple=True)
        if tok.numel():
            y = expert(x[tok]).float() * weight[tok, slot, None]
            out.index_add_(0, tok, y)
    return out.to(x.dtype)


def grouped_experts(x: torch.Tensor, sel: torch.Tensor, weight: torch.Tensor,
                    counts: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The MoE's output [T, D] from two grouped products, with no host
    synchronisation: x [T, D], sel and weight [T, k], counts [E] (tokens
    per expert), w13 [E, 2F, D] (each expert's w1 over its w3) and w2
    [E, D, F], in x's dtype.  The slots are sorted by expert (stably), the
    expert's weight scales its hidden row before the down product (a
    product is linear), and each token's k rows are summed in slot order."""
    T, k = sel.shape
    order = torch.argsort(sel.reshape(-1), stable=True)
    offs = counts.cumsum(0).to(torch.int32)
    h = torch._grouped_mm(x[order // k], w13.transpose(1, 2), offs=offs)
    a, b = h.chunk(2, dim=-1)
    g = F.silu(a) * b * weight.reshape(-1)[order, None].to(h.dtype)
    y = torch._grouped_mm(g, w2.transpose(1, 2), offs=offs)
    return torch.empty_like(y).index_copy_(0, order, y).view(T, k, -1).sum(dim=1)


class SparseMoe(nn.Module):
    def __init__(self, c: Lfm2MoeConfig, index: int):
        super().__init__()
        d, dt = c.hidden_size, c.torch_dtype
        self.c, self.index = c, index          # index: the MoE layer's row of the tally
        self.gate = Linear(d, c.num_experts, torch.float32, bias=False)
        if c.use_expert_bias:
            self.register_buffer("expert_bias", torch.zeros(c.num_experts))
        self.experts = nn.ModuleList(SwiGLU(d, c.moe_intermediate_size, dt)
                                     for _ in range(c.num_experts))

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(selected experts [T, k], their weights [T, k] fp32, tokens per
        expert [E] int64) of x [T, D]."""
        c = self.c
        s = torch.sigmoid(self.gate(x))
        choice = s + self.expert_bias if c.use_expert_bias else s
        sel = choice.topk(c.num_experts_per_tok, dim=-1).indices
        w = s.gather(-1, sel)
        if c.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + ROUTE_EPS)
        flat = sel.reshape(-1)
        counts = torch.zeros(c.num_experts, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        return sel, w * c.routed_scaling_factor, counts

    def stacked_weights(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w13 [E, 2F, D], w2 [E, D, F]) in ``dtype``: every expert's
        weights cast once into one buffer each."""
        E, f = self.c.num_experts, self.c.moe_intermediate_size
        w = self.experts[0].w1.weight
        w13 = torch.empty((E, 2 * f, w.shape[1]), dtype=dtype, device=w.device)
        w2 = torch.empty((E, w.shape[1], f), dtype=dtype, device=w.device)
        dst, src = [], []
        for e, ex in enumerate(self.experts):
            dst += [w13[e, :f], w13[e, f:], w2[e]]
            src += [ex.w1.weight, ex.w3.weight, ex.w2.weight]
        torch._foreach_copy_(dst, src)
        return w13, w2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        flat = x.reshape(-1, D)
        with span("reasoner.moe.route"):
            sel, w, counts = self.route(flat)
            tally(EXPERT_TALLY, self.index, counts, self.c.num_moe_layers)
        with span("reasoner.moe.experts"):
            if x.is_cuda and x.dtype == torch.bfloat16:
                y = grouped_experts(flat, sel, w, counts, *self.stacked_weights(x.dtype))
            else:
                y = looped_experts(flat, sel, w, self.experts)
        count("moe.layers")
        return y.view(B, L, D)


class DecoderLayer(nn.Module):
    def __init__(self, c: Lfm2MoeConfig, i: int):
        super().__init__()
        d, dt = c.hidden_size, c.torch_dtype
        self.is_attention_layer = c.layer_types[i] == "full_attention"
        if self.is_attention_layer:
            self.self_attn = Attention(c)
        else:
            self.conv = ShortConv(c)
        self.feed_forward = (SwiGLU(d, c.intermediate_size, dt) if i < c.num_dense_layers
                             else SparseMoe(c, i - c.num_dense_layers))
        self.operator_norm = RMSNorm(d, c.norm_eps, dt)
        self.ffn_norm = RMSNorm(d, c.norm_eps, dt)

    def forward(self, h, cos, sin, bias) -> torch.Tensor:
        if self.is_attention_layer:
            with span("reasoner.attention"):
                x = h + self.self_attn(self.operator_norm(h), cos, sin, bias)
            count("reasoner.attention.layers")
        else:
            with span("reasoner.conv"):
                x = h + self.conv(self.operator_norm(h))
            count("reasoner.conv.layers")
        return x + self.feed_forward(self.ffn_norm(x))


class Lfm2Reasoner(nn.Module):
    def __init__(self, c: Lfm2MoeConfig):
        super().__init__()
        self.config = c
        self.embed_tokens = Embedding(c.vocab_size, c.hidden_size, c.torch_dtype)
        self.layers = nn.ModuleList(DecoderLayer(c, i) for i in range(c.num_hidden_layers))
        self.embedding_norm = RMSNorm(c.hidden_size, c.norm_eps, c.torch_dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """After ``models/modcr.py::init_dense_weights_``: the embedding at
        normal(initializer_range), the convolutions at normal(1/√K), lecun's
        over a channel's K taps, every RMSNorm at 1, the expert bias at 0."""
        nn.init.normal_(self.embed_tokens.weight, 0.0, self.config.initializer_range,
                        generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                nn.init.normal_(m.weight, 0.0, m.weight.shape[-1] ** -0.5, generator=generator)
            elif isinstance(m, RMSNorm):
                nn.init.ones_(m.weight)
            elif isinstance(m, SparseMoe) and m.c.use_expert_bias:
                m.expert_bias.zero_()

    def cast_(self, dtype: torch.dtype) -> "Lfm2Reasoner":
        """The products', convolutions' and embeddings' weights cast to
        ``dtype`` in place (the scorer's cast); the routers, the expert
        biases and the norms stay fp32."""
        gates = {id(m.gate) for m in self.modules() if isinstance(m, SparseMoe)}
        for m in self.modules():
            if isinstance(m, (Linear, Embedding, nn.Conv1d)) and id(m) not in gates:
                m.to(dtype)
        return self

    def hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      prompt_embeddings: torch.Tensor) -> torch.Tensor:
        """The states [B, P + L, D] after the last layer, before
        ``embedding_norm``: the prefix [B, P, D], then the tokens."""
        c = self.config
        h = self.embed_tokens(input_ids)
        h = torch.cat([prompt_embeddings.to(h.dtype), h], dim=1)
        valid = torch.cat([torch.ones(prompt_embeddings.shape[:2], device=h.device),
                           attention_mask.float()], dim=-1)
        cos, sin = rope_tables(h.shape[1], c.head_dim, c.rope_theta, h.device)
        bias = causal_padding_bias(valid)
        for layer in self.layers:
            h = layer(h, cos, sin, bias)
        return h

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                prompt_embeddings: torch.Tensor) -> torch.Tensor:
        """The last valid token's state [B, D] after ``embedding_norm``."""
        h = self.hidden_states(input_ids, attention_mask, prompt_embeddings)
        last = prompt_embeddings.shape[1] + attention_mask.sum(dim=-1).long() - 1
        return self.embedding_norm(h[torch.arange(h.shape[0], device=h.device), last])
