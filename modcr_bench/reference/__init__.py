"""The plain fp32 reference: featurization (``data``), the model
(``model``) and its parameter names (``params``).

It imports neither JAX nor anything of the program.  It is given the raw
examples, the region features and the seed's weights, the same as the
program is given, and works everything else out again.  Products run in
true fp32 (TF32 off).  It runs in blocks of questions so that it fits
beside nothing: the program's state is freed before it runs.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import data, model


def true_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def geometry(kind: str, m: Dict) -> Dict:
    """The batch geometry of a configuration's model dict."""
    enc = m["global_encoder"]
    return dict(text_len=m["text_len"], img_len=m["img_len"], roberta_len=m["roberta_len"],
                num_labels=m["num_labels"], max_chunks=m["max_chunks"],
                img_feature_dim=enc["img_feature_dim"], bert_vocab=enc["vocab_size"],
                roberta_vocab=m["roberta"]["vocab_size"])


def tensors(examples: Sequence, feats: Dict[str, np.ndarray], geo: Dict, device) -> Dict:
    return {k: torch.from_numpy(v).to(device) for k, v in data.collate(examples, feats, geo).items()}


@torch.no_grad()
def score(kind: str, m: Dict, P: Dict[str, torch.Tensor], examples: Sequence, feats, device, *,
          block: int = 8) -> torch.Tensor:
    """ModCR's logits [Q, K] of ``examples`` (fp32, on the host)."""
    true_fp32()
    r, geo, out = model.Ref(P), geometry(kind, m), []
    for i in range(0, len(examples), block):
        logits = model.modcr_forward(r, m, tensors(examples[i:i + block], feats, geo, device))
        out.append(logits.float().cpu())
    return torch.cat(out)
