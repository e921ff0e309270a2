"""Work counts: the bytes and FLOPs that bound each kernel op, and the model
FLOPs of a forward.

Roofline bound of an op call: every tensor input read once and every
output written once at the HBM rate, or its FLOPs at the bf16 tensor-core
rate, whichever takes longer.  The count depends only on the op's
arguments, so it is the same whatever kernel implements the op.

Model FLOPs count the matrix products and the attention products the
model runs at its padded shapes (2 per multiply-add).  Embedding
gathers, softmax, norms and the chunk mean are not products and are not
counted.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores and HBM3.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# element bytes by the profiler's dtype names (``c10::`` dropped, lower case)
ITEMSIZE = {"bfloat16": 2, "half": 2, "float16": 2, "float": 4, "float32": 4, "int": 4,
            "int32": 4, "long": 8, "long int": 8, "int64": 8, "double": 8, "bool": 1,
            "unsigned char": 1, "signed char": 1, "short int": 2}


def itemsize(dtype: str) -> int:
    """Bytes of one element of a profiler dtype name; an unknown name
    raises rather than guessing a roofline."""
    key = dtype.replace("c10::", "").lower()
    if key not in ITEMSIZE:
        raise ValueError(f"unknown dtype {dtype!r} in a traced op's arguments")
    return ITEMSIZE[key]


def _numel(shape: Sequence[int]) -> int:
    return math.prod(shape) if shape else 0


def _bytes(shapes, dtypes) -> int:
    return sum(_numel(s) * itemsize(d) for s, d in zip(shapes, dtypes) if s)


def attention_flops(q_shape, k_shape, products: int) -> int:
    """``products`` [Lq x Dh] x [Dh x Lk]-sized products per head."""
    B, lq, H, dh = q_shape
    return 2 * products * B * H * lq * k_shape[1] * dh


def op_work(name: str, shapes: List[List[int]], dtypes: List[str],
            want_dbias: bool = False) -> Optional[Tuple[int, int]]:
    """(bytes, FLOPs) of one call of a ``modcr_torch`` op from its argument
    shapes and dtypes, or None for another op.

    - ``spec_attention(q, k, v, valid, gi, rowfull, stage, text_len)`` and
      ``dense_attention(q, k, v, bias?)``: out like q; QKᵀ and PV;
    - ``flash_bwd(q, k, v, bias?, d_out, want_dbias)``: dq, dk, dv like
      q, k, v, and the [B, Lq, Lk] fp32 bias plane when asked; QKᵀ
      recomputed, dV, dP, dQ and dK."""
    op = name.split("::")[-1].split(".")[0]
    if op in ("spec_attention", "dense_attention"):
        q, k = shapes[0], shapes[1]
        n = 6 if op == "spec_attention" else 4
        read = _bytes(shapes[:n], dtypes[:n])
        return read + _bytes([q], [dtypes[0]]), attention_flops(q, k, 2)
    if op == "flash_bwd":
        q, k, v = shapes[0], shapes[1], shapes[2]
        read = _bytes(shapes[:5], dtypes[:5])
        write = _bytes([q, k, v], dtypes[:3])
        if want_dbias:
            write += 4 * q[0] * q[1] * k[1]
        return read + write, attention_flops(q, k, 5)
    return None


def bound_seconds(nbytes: int, flops: int) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


# --- model FLOPs ---------------------------------------------------------

def _layer(rows: int, lq: int, lk: int, d: int, heads: int, ffn: int) -> int:
    """One post-LN layer over ``rows`` sequences of ``lq`` queries and
    ``lk`` keys (a prefix's projected vectors among them)."""
    dh = d // heads
    return 2 * (rows * lq * d * d                    # query
                + 2 * rows * lk * d * d              # key, value
                + 2 * rows * heads * lq * dh * lk    # QKᵀ, PV
                + rows * lq * d * d                  # out
                + 2 * rows * lq * d * ffn)           # FFN


def _encoder(c: Dict, rows: int, text: int, img: int) -> int:
    d, L = c["hidden_size"], text + img
    return (2 * rows * img * c["img_feature_dim"] * d                         # regions
            + c["num_hidden_layers"] * _layer(rows, L, L, d, c["num_attention_heads"],
                                              c["intermediate_size"])
            + 2 * rows * d * d)                                               # pooler


def modcr_flops(m: Dict, questions: int) -> int:
    """One ModCR forward over ``questions`` x num_labels candidate rows."""
    ge, se, sc, rc = m["global_encoder"], m["seq_encoder"], m["chunkalign"], m["roberta"]
    K, T, I, R, P = (m["num_labels"], m["text_len"], m["img_len"], m["roberta_len"],
                     2 * m["prefix_len"])
    rows = questions * K
    d, dr, p = ge["hidden_size"], rc["hidden_size"], m["prefix_len"]
    f = _encoder(ge, questions, 1, I) + _encoder(ge, rows, T, I) + _encoder(se, rows, T, I)
    # fusion: cls_ensemble_1, then single-query cross attention over 3(T-1)
    M, ffn = 3 * (T - 1), ge["intermediate_size"]
    f += 2 * rows * 2 * d * d
    f += sc["cls_layer_num"] * 2 * (2 * rows * d * d                         # q, out
                                     + 2 * rows * M * d * d                   # k, v
                                     + 2 * rows * M * d                       # scores, context
                                     + 2 * rows * d * ffn)                    # FFN
    # mapping networks: the vision one per question, the alignment one per row
    f += 2 * (questions + rows) * (d * d * p + d * p * dr * p)
    f += rc["num_hidden_layers"] * _layer(rows, R, R + P, dr, rc["num_attention_heads"],
                                          rc["intermediate_size"])
    return f + 2 * rows * (dr * dr + dr)                                      # pooler, scorer


MODEL_FLOPS = {"modcr": modcr_flops}
