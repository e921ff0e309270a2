"""The plain fp32 forward of ModCR with the LFM2-8B-A1B reasoner
(configuration kind ``modcr_lfm2``).

The towers, CALeC and the mapping networks are ``model.py``'s, imported and
unchanged; the mapped 10-vector prefix then enters the LFM2 reasoner as its
first input embeddings, and the last valid token's state after the final
RMSNorm is scored by ``abst_confidence_scorer``.  The reasoner is written
from transformers' ``models/lfm2/modeling_lfm2.py`` (the dense model) and
LFM2-8B-A1B's ``config.json`` (the MoE):

- ``RMSNorm(x) = w ⊙ x·rsqrt(mean(x²) + eps)``; layer: ``x = h +
  op(RMSNorm(h))``, ``h' = x + ffn(RMSNorm(x))``;
- conv: ``B, C, x = split₃(in_proj h)``, ``out_proj(C ⊙ conv1d(B ⊙ x))``
  with ``F.conv1d`` depthwise, padded by K - 1 and cut to L (causal);
- attention: per-head RMSNorm on q and k, RoPE (rotate-half) over
  positions 0..L-1, KV heads repeated to the query heads, softmax over a
  causal plus key-padding -10000 bias;
- MoE: ``s = sigmoid(gate x)``, top-k of ``s + expert_bias``, weights
  ``s_sel / (Σ s_sel + 1e-6) · routed_scaling_factor``, a loop over the
  experts, each ``w2(silu(w1 x) ⊙ w3 x)`` on its own tokens.  A ``route``
  hook, where given, sees each MoE layer's ``(prefix, s)`` before the
  selection (``lfm2_params.balance`` sets the expert biases through it).

Plain ``torch`` on a dict of parameters, nothing of the program and no
JAX; true fp32 (``reference.true_fp32``), in blocks of questions.  With
``low`` (the control of ``correct``: a precision below the configuration's
bf16) every product of the reasoner that the program computes in bf16
rounds both operands to ``low`` first, each scaled by its amax; the router
stays fp32, as the program's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from . import data, model, true_fp32

NEG = model.NEG


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rounded(x: torch.Tensor, low: Optional[torch.dtype]) -> torch.Tensor:
    """x as ``low`` holds it, scaled by its amax into ``low``'s range."""
    if low is None:
        return x
    s = x.abs().amax().clamp_min(1e-30) / torch.finfo(low).max
    return (x / s).to(low).to(x.dtype) * s


def mm(a: torch.Tensor, b: torch.Tensor, low: Optional[torch.dtype] = None) -> torch.Tensor:
    return rounded(a, low) @ rounded(b, low)


def swiglu(P, pre: str, x: torch.Tensor, low=None) -> torch.Tensor:
    a = mm(x, P[pre + "w1.weight"].t(), low)
    b = mm(x, P[pre + "w3.weight"].t(), low)
    return mm(F.silu(a) * b, P[pre + "w2.weight"].t(), low)


def moe(P, pre: str, c: Dict, x: torch.Tensor, low=None, route=None) -> torch.Tensor:
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    s = torch.sigmoid(x @ P[pre + "gate.weight"].t())
    if route is not None:
        route(pre, s)
    choice = s + P[pre + "expert_bias"] if c["use_expert_bias"] else s
    top = choice.topk(c["num_experts_per_tok"], dim=-1).indices
    w = s.gather(-1, top)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-6)
    w = w * c["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(c["num_experts"]):
        hit = top == e                                   # [T, k]
        rows = hit.any(-1).nonzero(as_tuple=True)[0]
        if rows.numel():
            we = (w * hit).sum(-1)[rows, None]
            out[rows] += we * swiglu(P, f"{pre}experts.{e}.", x[rows], low)
    return out.view(shape)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, L, Dh] rotated by position 0..L-1."""
    L, dh = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device, dtype=torch.float32) / dh)
    ang = torch.arange(L, device=x.device, dtype=torch.float32)[:, None] * inv[None]
    emb = torch.cat([ang, ang], -1)
    half = dh // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * emb.cos() + rot * emb.sin()


def lfm2(P, c: Dict, ids: torch.Tensor, attn_mask: torch.Tensor, prefix: torch.Tensor,
         low: Optional[torch.dtype] = None, route=None) -> torch.Tensor:
    """The LFM2 reasoner over the prefix [B, P, D] and the tokens: the last
    valid token's normed state [B, D]."""
    pre, eps = "reasoner.", c["norm_eps"]
    h = torch.cat([prefix, P[pre + "embed_tokens.weight"][ids]], dim=1)
    B, L, D = h.shape
    H, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    dh = D // H
    valid = torch.cat([torch.ones(prefix.shape[:2], device=h.device), attn_mask.float()], -1)
    causal = torch.tril(torch.ones(L, L, device=h.device))
    bias = ((1.0 - causal[None] * valid[:, None, :]) * NEG)[:, None]
    for i, kind in enumerate(c["layer_types"]):
        p = f"{pre}layers.{i}."
        a = rms(h, P[p + "operator_norm.weight"], eps)
        if kind == "conv":
            b, gate, x = mm(a, P[p + "conv.in_proj.weight"].t(), low).chunk(3, dim=-1)
            w = P[p + "conv.conv.weight"]
            conv = F.conv1d((b * x).transpose(1, 2), w, padding=w.shape[-1] - 1, groups=D)
            o = mm(gate * conv[..., :L].transpose(1, 2), P[p + "conv.out_proj.weight"].t(), low)
        else:
            q = mm(a, P[p + "self_attn.q_proj.weight"].t(), low).view(B, L, H, dh).transpose(1, 2)
            k = mm(a, P[p + "self_attn.k_proj.weight"].t(), low).view(B, L, Hkv, dh).transpose(1, 2)
            v = mm(a, P[p + "self_attn.v_proj.weight"].t(), low).view(B, L, Hkv, dh).transpose(1, 2)
            q = rope(rms(q, P[p + "self_attn.q_layernorm.weight"], eps), c["rope_theta"])
            k = rope(rms(k, P[p + "self_attn.k_layernorm.weight"], eps), c["rope_theta"])
            k = k.repeat_interleave(H // Hkv, dim=1)
            v = v.repeat_interleave(H // Hkv, dim=1)
            probs = torch.softmax(mm(q, k.transpose(-1, -2), low) / math.sqrt(dh) + bias, dim=-1)
            o = mm(mm(probs, v, low).transpose(1, 2).reshape(B, L, D),
                   P[p + "self_attn.out_proj.weight"].t(), low)
        h = h + o
        a = rms(h, P[p + "ffn_norm.weight"], eps)
        if i < c["num_dense_layers"]:
            h = h + swiglu(P, p + "feed_forward.", a, low)
        else:
            h = h + moe(P, p + "feed_forward.", c, a, low, route)
    last = prefix.shape[1] + attn_mask.sum(-1).long() - 1
    return rms(h[torch.arange(B, device=h.device), last], P[pre + "embedding_norm.weight"], eps)


def forward(P, m: Dict, b: Dict[str, torch.Tensor],
            low: Optional[torch.dtype] = None, route=None) -> torch.Tensor:
    """ModCR-LFM2's 4-way logits [Q, K]: ``model.py``'s towers, fusion and
    mapping networks (the vision prefix once per question), then LFM2."""
    r = model.Ref(P)
    ge, se, sc, c = m["global_encoder"], m["seq_encoder"], m["chunkalign"], m["lfm2"]
    K, T = m["num_labels"], b["input_ids"].shape[1]
    ids, tm, im, feat = b["input_ids"], b["text_mask"], b["img_mask"], b["img_feat"]
    rows = slice(None, None, K)
    vis = model.global_encoder(r, "calec.global_enc.", ge, ids[rows, :1], feat[rows],
                               torch.cat([tm[rows, :1], im[rows]], -1))
    p_vis = model.mapping(r, "mapping_network_vision", vis.sequence[:, 0], m["prefix_len"],
                          c["hidden_size"]).repeat_interleave(K, dim=0)
    g = model.global_encoder(r, "calec.global_enc.", ge, ids, feat, torch.cat([tm, im], -1),
                             b["token_type_ids"])
    s = model.chunkalign_encoder(r, "calec.seq_enc.", se, sc, m["max_chunks"], b)
    cls = r.linear("calec.cls_ensemble_1", torch.cat([g.pooled, s.pooled], -1))
    memory = torch.cat([g.sequence[:, 1:T], s.sequence[:, 1:T], s.chunk_hidden[:, 1:T]], dim=1)
    word = tm[:, 1:T]
    mbias = ((1.0 - torch.cat([word, word, word], -1)) * NEG)[:, None, None, :]
    heads = sc["cls_num_heads"]
    B, M, D = memory.shape
    dh = D // heads
    for i in range(sc["cls_layer_num"]):
        pre = f"calec.cls_layer_lyx.{i}."
        q = r.linear(pre + "cross_attention.q_proj", cls[:, None]).view(B, 1, heads, dh).transpose(1, 2)
        k = r.linear(pre + "cross_attention.k_proj", memory).view(B, M, heads, dh).transpose(1, 2)
        v = r.linear(pre + "cross_attention.v_proj", memory).view(B, M, heads, dh).transpose(1, 2)
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh) + mbias, dim=-1)
        o = r.linear(pre + "cross_attention.out_proj", (p @ v).transpose(1, 2).reshape(B, D))
        cls = r.ffn(pre, r.norm(pre + "LayerNorm", o + cls, se["layer_norm_eps"]), se["layer_norm_eps"])
    p_align = model.mapping(r, "mapping_network_alignment", cls, m["prefix_len"], c["hidden_size"])
    state = lfm2(P, c, b["r_input_ids"], b["r_attention_mask"], torch.cat([p_vis, p_align], 1),
                 low, route)
    return r.linear("abst_confidence_scorer", state).view(-1, K)


def geometry(m: Dict) -> Dict:
    """The batch geometry of a ``modcr_lfm2`` model dict: the reasoner's
    hash tokenizer draws from LFM2's vocabulary."""
    enc = m["global_encoder"]
    return dict(text_len=m["text_len"], img_len=m["img_len"], roberta_len=m["roberta_len"],
                num_labels=m["num_labels"], max_chunks=m["max_chunks"],
                img_feature_dim=enc["img_feature_dim"], bert_vocab=enc["vocab_size"],
                roberta_vocab=m["lfm2"]["vocab_size"])


@torch.no_grad()
def score(m: Dict, P: Dict[str, torch.Tensor], examples: Sequence, feats, device, *,
          block: int = 8, low: Optional[torch.dtype] = None) -> torch.Tensor:
    """ModCR-LFM2's logits [Q, K] of ``examples`` (fp32, on the host)."""
    true_fp32()
    geo, out = geometry(m), []
    for i in range(0, len(examples), block):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in data.collate(examples[i:i + block], feats, geo).items()}
        out.append(forward(P, m, b, low).float().cpu())
    return torch.cat(out)
