"""Work counts of ModCR with the LFM2 reasoner (configuration kind
``modcr_lfm2``): the model FLOPs of a scoring batch, and the work of the
routed experts' products, which bounds ``moe_roofline.lfm2``.

As ``counts.py`` counts: the matrix and attention products at the padded
shapes, 2 FLOPs a multiply-add; norms, gates, the convolution's three taps,
softmax and the routing are not products and are not counted.  The
experts' work depends only on the configuration and the batch (every token
goes to exactly k experts), so it is the same whatever implements them.
"""

from __future__ import annotations

from typing import Dict, Tuple

from modcr_bench import counts

BF16 = 2


def _tokens(m: Dict, questions: int) -> Tuple[int, int, int]:
    """(rows, positions a row, tokens) of a batch: the prefix, then the
    reasoner's tokens."""
    rows = questions * m["num_labels"]
    length = 2 * m["prefix_len"] + m["roberta_len"]
    return rows, length, rows * length


def reasoner_flops(m: Dict, questions: int) -> int:
    c = m["lfm2"]
    rows, length, T = _tokens(m, questions)
    d, H = c["hidden_size"], c["num_attention_heads"]
    kv = c["num_key_value_heads"] * (d // H)
    f = 0
    for i, kind in enumerate(c["layer_types"]):
        if kind == "conv":
            f += 2 * T * d * 3 * d + 2 * T * d * d                     # in_proj, out_proj
        else:
            f += 2 * T * d * (2 * d + 2 * kv)                          # q, k, v, out
            f += 2 * 2 * rows * H * length * length * (d // H)         # QKᵀ, PV
        if i < c["num_dense_layers"]:
            f += 2 * T * 3 * d * c["intermediate_size"]
        else:
            f += 2 * T * d * c["num_experts"]                          # the router
    _, expert = expert_work(m, questions)
    return f + expert


def model_flops(m: Dict, questions: int) -> int:
    """One ModCR-LFM2 forward over ``questions`` x num_labels candidate
    rows: ``counts.py``'s towers, fusion and mapping networks (the latter
    at the reasoner's width), then LFM2 and the scorer."""
    ge, se, sc = m["global_encoder"], m["seq_encoder"], m["chunkalign"]
    K, T, I, p = m["num_labels"], m["text_len"], m["img_len"], m["prefix_len"]
    rows = questions * K
    d, dr = ge["hidden_size"], m["lfm2"]["hidden_size"]
    f = (counts._encoder(ge, questions, 1, I) + counts._encoder(ge, rows, T, I)
         + counts._encoder(se, rows, T, I))
    M, ffn = 3 * (T - 1), ge["intermediate_size"]
    f += 2 * rows * 2 * d * d
    f += sc["cls_layer_num"] * 2 * (2 * rows * d * d + 2 * rows * M * d * d
                                     + 2 * rows * M * d + 2 * rows * d * ffn)
    f += 2 * (questions + rows) * (d * d * p + d * p * dr * p)
    return f + reasoner_flops(m, questions) + 2 * rows * dr


def expert_work(m: Dict, questions: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of a batch's routed-expert products over every MoE
    layer: each token's rows through k experts' w1, w3 and w2; every
    expert's bf16 weights read once, the permuted rows read (D wide), the
    gate and up outputs written (2F), the gated hidden read (F) and the
    down output written (D), in bf16."""
    c = m["lfm2"]
    _, _, T = _tokens(m, questions)
    d, f, E, k = (c["hidden_size"], c["moe_intermediate_size"], c["num_experts"],
                  c["num_experts_per_tok"])
    layers = c["num_hidden_layers"] - c["num_dense_layers"]
    nbytes = BF16 * (E * 3 * d * f + T * k * (d + 2 * f + f + d))
    return layers * nbytes, layers * 2 * T * k * 3 * d * f


def expert_bound_seconds(m: Dict, questions: int) -> float:
    """The least time a batch's expert products take on the card: per MoE
    layer, bytes at the HBM rate or FLOPs at the bf16 rate, whichever is
    longer."""
    c = m["lfm2"]
    layers = c["num_hidden_layers"] - c["num_dense_layers"]
    nbytes, flops = expert_work(m, questions)
    return layers * counts.bound_seconds(nbytes // layers, flops // layers)
