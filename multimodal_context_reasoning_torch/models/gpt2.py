"""GPT-2 decoder with cross-attention and a static KV cache (port of the JAX
package's ``models/gpt2.py``).

Pre-LN blocks, causal self-attention, optional cross-attention over an
encoder memory in every block, and an LM head tied to ``wte`` or, for the
rationale family, an untied ``lm_head`` owned by the caller.  Module names
are the vendored GPT-2's (HF layout), so a reference ``dec.*`` state dict
loads as it is: ``h.N.attn.c_attn`` is the fused [in, 3D] Conv1D of q, k and
v, ``h.N.crossattention.q_attn`` and ``h.N.crossattention.c_attn`` ([in, 2D],
k and v of the memory), ``h.N.ln_cross_attn``.  The reference's causal-mask
buffers (``attn.bias``, ``attn.masked_bias``) are not kept.

The decoder computes in fp32 whatever ``GPT2Config.dtype`` says, as the JAX
package's does (its Dense, LayerNorm and Embed take no dtype); callers cast
the memory to fp32.

Decoding uses a static cache ``[n_layer, B, L_max, H, Dh]`` per K and V,
written in place at ``cache_index`` (a Python int).  Each cached call
attends over the whole cache with the causal-by-position mask (slot ``j`` is
visible to input position ``i`` when ``j <= cache_index + i``) plus
``cache_valid`` [B, L_max], which hides right-padded prompt slots.  The
memory's keys and values do not change while decoding:
:meth:`GPT2Decoder.cross_kv` projects them once, and a call given them skips
that projection (the same bits as projecting each step).  They may cover
fewer rows than the call decodes: one memory for each group of consecutive
rows (the beam and lattice decodes of generation/ keep one per question for
its B·K or B·S·K rows, so the cross keys and values are not copied per row);
``memory_mask`` then has the memory's rows too.

Under tensor parallelism (parallel/partition.py) each ``Conv1D`` holds a
block of output features (``c_attn`` one of each of q, k and v, ``q_attn``,
``mlp.c_fc``) or of input features (the ``c_proj`` products, summed over the
group before the whole bias is added), and the attention modules take their
local head count from the width they get: :meth:`GPT2Decoder.new_cache`
sizes the cache to it.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import GPT2Config
from multimodal_context_reasoning_torch.models.layers import ACT
from multimodal_context_reasoning_torch.ops.attention import dot_product_attention
from multimodal_context_reasoning_torch.ops.masks import NEG_INF
from multimodal_context_reasoning_torch.parallel.comm import copy_to_group, reduce_from_group

CrossKV = List[Tuple[torch.Tensor, torch.Tensor]]   # per block: [B, M, H, Dh] each


class KVCache(NamedTuple):
    """Static decode cache, one [B, L_max, H, Dh] slab per layer."""

    k: torch.Tensor  # [n_layer, B, L_max, H, Dh]
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: GPT2Config, batch: int, max_len: int,
              device: Union[str, torch.device], heads: Optional[int] = None) -> "KVCache":
        shape = (cfg.n_layer, batch, max_len, heads or cfg.n_head, cfg.head_dim)
        return cls(torch.zeros(shape, device=device), torch.zeros(shape, device=device))


class Conv1D(nn.Module):
    """The vendored GPT-2's Conv1D: ``x @ weight + bias`` with ``weight``
    stored [in, out] (``tp_mode`` / ``tp_group``: the module docstring)."""

    tp_mode: Optional[str] = None
    tp_group = None

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_mode == "col":
            x = copy_to_group(x, self.tp_group)
        elif self.tp_mode == "row":
            return reduce_from_group(torch.matmul(x, self.weight), self.tp_group) + self.bias
        return torch.matmul(x, self.weight) + self.bias


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    B, L, _ = x.shape
    return x.reshape(B, L, -1, head_dim)


class GPT2Attention(nn.Module):
    """Causal self-attention (``attn.c_attn``, ``attn.c_proj``)."""

    def __init__(self, c: GPT2Config):
        super().__init__()
        self.config = c
        self.c_attn = Conv1D(c.n_embd, 3 * c.n_embd)
        self.c_proj = Conv1D(c.n_embd, c.n_embd)
        self.resid_dropout = nn.Dropout(c.resid_pdrop)

    def forward(self, h, bias, cache_kv, cache_index):
        c = self.config
        B, L, _ = h.shape
        qkv = self.c_attn(h)
        q, k, v = (_heads(t, c.head_dim) for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
        if cache_kv is not None:
            ck, cv = cache_kv
            ck[:, cache_index:cache_index + L] = k
            cv[:, cache_index:cache_index + L] = v
            k, v = ck, cv
        out, _ = dot_product_attention(q, k, v, bias, dropout_rate=c.attn_pdrop,
                                       training=self.training)
        return self.resid_dropout(self.c_proj(out.reshape(B, L, -1)))


class GPT2CrossAttention(nn.Module):
    """Cross-attention over the encoder memory (``crossattention.q_attn``,
    ``crossattention.c_attn``, ``crossattention.c_proj``)."""

    def __init__(self, c: GPT2Config):
        super().__init__()
        self.config = c
        self.q_attn = Conv1D(c.n_embd, c.n_embd)
        self.c_attn = Conv1D(c.n_embd, 2 * c.n_embd)
        self.c_proj = Conv1D(c.n_embd, c.n_embd)
        self.resid_dropout = nn.Dropout(c.resid_pdrop)

    def kv(self, memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        kv = self.c_attn(memory)
        k, v = kv.split(kv.shape[-1] // 2, dim=-1)
        return _heads(k, self.config.head_dim), _heads(v, self.config.head_dim)

    def forward(self, h, kv, memory_bias):
        B, L, _ = h.shape
        q = _heads(self.q_attn(h), self.config.head_dim)
        G = kv[0].shape[0]
        if G != B:
            # one memory per group of B // G consecutive rows: the group's
            # queries attend as one block, each query row on its own
            q = q.reshape(G, (B // G) * L, *q.shape[2:])
        out, _ = dot_product_attention(q, *kv, memory_bias)
        return self.resid_dropout(self.c_proj(out.reshape(B, L, -1)))


class GPT2MLP(nn.Module):
    def __init__(self, c: GPT2Config):
        super().__init__()
        self.c_fc = Conv1D(c.n_embd, c.inner_dim)
        self.c_proj = Conv1D(c.inner_dim, c.n_embd)
        self.act = ACT[c.activation_function]
        self.dropout = nn.Dropout(c.resid_pdrop)

    def forward(self, h):
        return self.dropout(self.c_proj(self.act(self.c_fc(h))))


class GPT2Block(nn.Module):
    """Pre-LN block: ln_1 -> self-attention -> residual, [ln_cross_attn ->
    cross-attention -> residual,] ln_2 -> MLP -> residual."""

    def __init__(self, c: GPT2Config):
        super().__init__()
        eps = c.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(c.n_embd, eps=eps)
        self.attn = GPT2Attention(c)
        if c.add_cross_attention:
            self.ln_cross_attn = nn.LayerNorm(c.n_embd, eps=eps)
            self.crossattention = GPT2CrossAttention(c)
        self.ln_2 = nn.LayerNorm(c.n_embd, eps=eps)
        self.mlp = GPT2MLP(c)

    def forward(self, hidden, bias, *, cross_kv=None, memory_bias=None, cache_kv=None,
                cache_index=0):
        hidden = hidden + self.attn(self.ln_1(hidden), bias, cache_kv, cache_index)
        if cross_kv is not None:
            hidden = hidden + self.crossattention(self.ln_cross_attn(hidden), cross_kv,
                                                  memory_bias)
        return hidden + self.mlp(self.ln_2(hidden))


class GPT2Decoder(nn.Module):
    """GPT-2 LM with cross-attention (``wte``, ``wpe``, ``h.N``, ``ln_f``).

    With ``tie_word_embeddings`` the logits are ``h @ wte.weight.T``;
    otherwise they come from ``lm_head``, an ``nn.Linear(n_embd, vocab,
    bias=False)`` that the caller owns and registers (the rationale family
    keeps it at its root, ``lm_head.weight``)."""

    def __init__(self, c: GPT2Config, lm_head: Optional[nn.Linear] = None):
        super().__init__()
        self.config = c
        self.wte = nn.Embedding(c.vocab_size, c.n_embd)
        self.wpe = nn.Embedding(c.n_positions, c.n_embd)
        self.drop = nn.Dropout(c.embd_pdrop)
        self.h = nn.ModuleList(GPT2Block(c) for _ in range(c.n_layer))
        self.ln_f = nn.LayerNorm(c.n_embd, eps=c.layer_norm_epsilon)
        if not c.tie_word_embeddings and lm_head is None:
            raise ValueError("an untied GPT-2 head needs the caller's lm_head")
        # a list, so that the caller's head is not registered here as well
        self._head = None if c.tie_word_embeddings else [lm_head]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: normal(initializer_range) for the
        embeddings and an untied head, lecun-normal Conv1D weights (fan-in
        rows) with zero biases, LayerNorm at 1 and 0."""
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, std, generator=generator)
            elif isinstance(m, Conv1D):
                s = math.sqrt(1.0 / m.weight.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        if self._head is not None:
            nn.init.normal_(self._head[0].weight, 0.0, std, generator=generator)

    def new_cache(self, batch: int, max_len: int,
                  device: Union[str, torch.device]) -> KVCache:
        """A zero cache for this decoder's (local) heads."""
        heads = self.h[0].attn.c_attn.weight.shape[1] // (3 * self.config.head_dim)
        return KVCache.zeros(self.config, batch, max_len, device, heads)

    def cross_kv(self, memory: torch.Tensor) -> CrossKV:
        """Every block's cross-attention keys and values of ``memory``."""
        return [blk.crossattention.kv(memory) for blk in self.h]

    def forward(self, input_ids: torch.Tensor, **kw) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """``(logits, cache)``: the LM head over :meth:`final_hidden`'s
        states (its keywords)."""
        h, cache = self.final_hidden(input_ids, **kw)
        if self._head is None:
            return h @ self.wte.weight.t(), cache
        return self._head[0](h), cache

    def final_hidden(
        self,
        input_ids: torch.Tensor,                          # [B, L]
        *,
        position_offset: Union[int, torch.Tensor, None] = None,   # scalar or [B]
        memory: Optional[torch.Tensor] = None,            # [B, M, D] fp32
        memory_mask: Optional[torch.Tensor] = None,       # [B | G, M] {0,1}
        cross_kv: Optional[CrossKV] = None,               # cross_kv(memory), B or G rows
        cache: Optional[KVCache] = None,                  # written in place
        cache_index: int = 0,
        cache_valid: Optional[torch.Tensor] = None,       # [B, L_max] {0,1}
        attn_mask: Optional[torch.Tensor] = None,         # [B, L] {0,1}, uncached
    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """The hidden states after ``ln_f`` [B, L, D] and the cache, without
        the LM head: what the JAX decoder's ``output_hidden=True`` adds to
        its logits.  A caller that reads only the states skips the [B, L,
        vocab] product, as XLA drops it from the JAX decoder's jitted
        program."""
        c = self.config
        B, L = input_ids.shape
        dev = input_ids.device
        pos = torch.arange(L, device=dev)[None]
        if position_offset is not None:
            # a [B] offset is per row ([B, 1]), never crossed with the positions
            off = torch.as_tensor(position_offset, device=dev)
            pos = pos + (off[:, None] if off.dim() == 1 else off)
        h = self.drop(self.wte(input_ids) + self.wpe(pos))

        if cache is not None:
            Lc = cache.k.shape[2]
            visible = (torch.arange(Lc, device=dev)[None, :]
                       <= (cache_index + torch.arange(L, device=dev))[:, None])   # [L, Lc]
            bias = torch.where(visible, 0.0, NEG_INF)[None, None]
            if cache_valid is not None:
                # right-padded prompt slots were written too: hide them
                bias = bias + ((1.0 - cache_valid.float()) * NEG_INF)[:, None, None, :]
        else:
            causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
            bias = torch.where(causal, 0.0, NEG_INF)[None, None]
            if attn_mask is not None:
                bias = bias + ((1.0 - attn_mask.float()) * NEG_INF)[:, None, None, :]

        memory_bias = None
        if c.add_cross_attention and (memory is not None or cross_kv is not None):
            if cross_kv is None:
                cross_kv = self.cross_kv(memory)
            if memory_mask is not None:
                memory_bias = ((1.0 - memory_mask.float()) * NEG_INF)[:, None, None, :]
        for i, blk in enumerate(self.h):
            h = blk(h, bias, cross_kv=None if cross_kv is None else cross_kv[i],
                    memory_bias=memory_bias,
                    cache_kv=None if cache is None else (cache.k[i], cache.v[i]),
                    cache_index=cache_index)
        return self.ln_f(h), cache
