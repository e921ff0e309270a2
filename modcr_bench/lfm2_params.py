"""Names and shapes of the parameters of ModCR with the LFM2 reasoner
(configuration kind ``modcr_lfm2``), from the configuration alone, and the
seed's weights of them.

The towers, CALeC and the two mapping networks are ``reference/params.py``'s,
the mapping networks at the reasoner's width; the reasoner lies under
``reasoner.`` in the published LFM2 checkpoint's layout (``embed_tokens``,
``layers.{i}.conv.{in_proj,conv,out_proj}``, ``layers.{i}.self_attn.*``,
``layers.{i}.feed_forward.{w1,w2,w3}`` or ``feed_forward.{gate,expert_bias,
experts.{e}.*}``, the norms, ``embedding_norm``).

Weights: ``weights.make``'s one draw over every parameter, then three kinds
that its rules do not know scaled in place, the same on every side:

- every RMSNorm weight: 1 + N(0, 0.05), as a LayerNorm weight;
- a convolution's [D, 1, K] taps: N(0, 1/K), lecun over a channel's taps
  (at ``make``'s 0.02 the gated convolution would add next to nothing);
- ``expert_bias``: N(0, 0.05), a bias that decides part of the selection
  (sigmoid scores near the top-k edge lie about 0.03 apart).

A cell then sets every ``expert_bias`` by :func:`balance`, as training
would have: random gates over correlated states send the busiest expert
several times the mean, and LFM2 trains its expert bias to even the load
out.  :func:`balance` runs the aux-loss-free rule (DeepSeek-V3's: ``b_e +=
γ·sign(mean load - load_e)``) to rest on one calibration batch, layer by
layer in the reference's forward, and the program and the reference both
take the biases it gives.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from . import weights
from .reference import data, true_fp32
from .reference import lfm2 as reference
from .reference import params as base

Shapes = base.Shapes
EXPERT_BIAS_STD = 0.05
BALANCE_STEPS = 300         # steps of the balancing rule a MoE layer
BALANCE_RATE = 1e-2         # its first step γ; each later one BALANCE_DECAY of the last
BALANCE_DECAY = 0.985


def _bare(name: str, i: int, o: int) -> Shapes:
    return [(name + ".weight", (o, i))]


def _swiglu(pre: str, d: int, f: int) -> Shapes:
    return _bare(pre + "w1", d, f) + _bare(pre + "w3", d, f) + _bare(pre + "w2", f, d)


def reasoner(pre: str, c: Dict) -> Shapes:
    """The LFM2 reasoner of config ``c`` (the published keys) under ``pre``."""
    d, dh = c["hidden_size"], c["hidden_size"] // c["num_attention_heads"]
    kv = c["num_key_value_heads"] * dh
    out = [(pre + "embed_tokens.weight", (c["vocab_size"], d))]
    for i, kind in enumerate(c["layer_types"]):
        p = f"{pre}layers.{i}."
        if kind == "conv":
            out += (_bare(p + "conv.in_proj", d, 3 * d)
                    + [(p + "conv.conv.weight", (d, 1, c["conv_L_cache"]))]
                    + _bare(p + "conv.out_proj", d, d))
        else:
            out += (_bare(p + "self_attn.q_proj", d, d) + _bare(p + "self_attn.k_proj", d, kv)
                    + _bare(p + "self_attn.v_proj", d, kv) + _bare(p + "self_attn.out_proj", d, d)
                    + [(p + "self_attn.q_layernorm.weight", (dh,)),
                       (p + "self_attn.k_layernorm.weight", (dh,))])
        if i < c["num_dense_layers"]:
            out += _swiglu(p + "feed_forward.", d, c["intermediate_size"])
        else:
            out += _bare(p + "feed_forward.gate", d, c["num_experts"])
            if c["use_expert_bias"]:
                out.append((p + "feed_forward.expert_bias", (c["num_experts"],)))
            for e in range(c["num_experts"]):
                out += _swiglu(f"{p}feed_forward.experts.{e}.", d, c["moe_intermediate_size"])
        out += [(p + "operator_norm.weight", (d,)), (p + "ffn_norm.weight", (d,))]
    return out + [(pre + "embedding_norm.weight", (d,))]


def modcr_lfm2(m: Dict) -> Shapes:
    ge, se, sc, c = m["global_encoder"], m["seq_encoder"], m["chunkalign"], m["lfm2"]
    d, dr, p = ge["hidden_size"], c["hidden_size"], m["prefix_len"]
    out = base._linear("calec.cls_ensemble_1", 2 * d, d)
    for i in range(sc["cls_layer_num"]):
        pre = f"calec.cls_layer_lyx.{i}."
        out += base._ffn(pre, d, ge["intermediate_size"])
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += base._linear(pre + "cross_attention." + n, d, d)
        out += base._norm(pre + "LayerNorm", d)
    out += (base.encoder("calec.global_enc.", ge, edge=False)
            + base.encoder("calec.seq_enc.", se, edge=True))
    out += reasoner("reasoner.", c)
    for net in ("mapping_network_vision", "mapping_network_alignment"):
        out += base._linear(net + ".1", d, d * p) + base._linear(net + ".4", d * p, dr * p)
    return out + base._linear("abst_confidence_scorer", dr, 1)


def make(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's fp32 weights of model dict ``m`` (views of one buffer)."""
    out = weights.make(modcr_lfm2(m), seed, device)
    with torch.no_grad():
        for name, t in out.items():
            if name.startswith("reasoner.") and name.endswith("norm.weight"):
                t.mul_(weights.NORM_STD / weights.INIT_STD).add_(1.0)
            elif name.endswith("conv.conv.weight"):
                t.mul_(1.0 / math.sqrt(t.shape[-1]) / weights.INIT_STD)
            elif name.endswith("expert_bias"):
                t.mul_(EXPERT_BIAS_STD / weights.INIT_STD)
    return out


def fit_bias(s: torch.Tensor, k: int) -> torch.Tensor:
    """The expert bias [E] that balances the top-``k`` selection of scores
    s [T, E]: the aux-loss-free rule from 0, ``BALANCE_STEPS`` steps of a
    shrinking γ."""
    E = s.shape[1]
    bias = torch.zeros(E, dtype=s.dtype, device=s.device)
    ones = torch.ones(s.shape[0] * k, dtype=s.dtype, device=s.device)
    mean = s.shape[0] * k / E
    for t in range(BALANCE_STEPS):
        top = (s + bias).topk(k, dim=-1).indices.reshape(-1)
        load = torch.zeros(E, dtype=s.dtype, device=s.device).index_add_(0, top, ones)
        bias += BALANCE_RATE * BALANCE_DECAY ** t * torch.sign(mean - load)
    return bias


@torch.no_grad()
def balance(m: Dict, P: Dict[str, torch.Tensor], examples: Sequence, feats,
            device) -> Dict[str, torch.Tensor]:
    """Set every ``expert_bias`` of ``P`` in place by :func:`fit_bias` on the
    tokens (padding too, as the program routes them) of ``examples``, one
    reference forward (fp32) in which each MoE layer is balanced before its
    selection; the biases, by name."""
    if not m["lfm2"]["use_expert_bias"]:
        return {}
    true_fp32()
    k = m["lfm2"]["num_experts_per_tok"]

    def route(pre: str, s: torch.Tensor) -> None:
        P[pre + "expert_bias"].copy_(fit_bias(s, k))

    b = {key: torch.from_numpy(v).to(device)
         for key, v in data.collate(examples, feats, reference.geometry(m)).items()}
    reference.forward(P, m, b, route=route)
    return {n: t.clone() for n, t in P.items() if n.endswith("expert_bias")}
