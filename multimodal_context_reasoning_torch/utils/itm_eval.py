"""Image-text retrieval evaluation, R@K both directions (a copy of the JAX
package's ``utils/itm_eval.py``).

Rebuilds ``utils/itm_eval.py:19-66`` (itm_eval) minus its broken imports and
Horovod dependency: given a [n_texts, n_images] score matrix and the gold
text→image assignment, compute Recall@{1,5,10} in both directions plus the
mean ("ar" fields of the reference's result dict), in numpy on the host.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def itm_eval(
    score_matrix: np.ndarray,      # [n_texts, n_images]
    txt_to_img: Sequence[int],     # gold image index per text row
    ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    scores = np.asarray(score_matrix)
    n_txt, n_img = scores.shape
    gold_img = np.asarray(txt_to_img)

    # text → image: rank of the gold image per text
    order = np.argsort(-scores, axis=1)                       # [n_txt, n_img]
    tr_rank = np.argmax(order == gold_img[:, None], axis=1)

    # image → text: score column per image, gold texts = rows mapping to it
    order_t = np.argsort(-scores, axis=0)                     # [n_txt, n_img]
    # best (lowest) rank over an image's gold texts
    ir_rank = np.full((n_img,), n_txt, np.int64)
    for t, img in enumerate(gold_img):
        r = int(np.argmax(order_t[:, img] == t))
        ir_rank[img] = min(ir_rank[img], r)
    has_text = np.isin(np.arange(n_img), gold_img)

    out: Dict[str, float] = {}
    for k in ks:
        out[f"txt_r{k}"] = float(np.mean(tr_rank < k))
        out[f"img_r{k}"] = float(np.mean(ir_rank[has_text] < k))
    out["txt_ar"] = float(np.mean([out[f"txt_r{k}"] for k in ks]))
    out["img_ar"] = float(np.mean([out[f"img_r{k}"] for k in ks]))
    out["rsum"] = float(
        sum(out[f"txt_r{k}"] + out[f"img_r{k}"] for k in ks)
    )
    return out
