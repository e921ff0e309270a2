"""The port's ``ChunkAlignClassifier`` -> the reference's checkpoint layout
(port of the JAX package's ``interop/export.py:export_chunkalign_cls_state_dict``).

The stage-1 ChunkAlign pretrain checkpoint (``ChunkAlign_CLS_enc4_align``,
v10.py:1016-1165) is what the production trainer strips of ``seq_enc.`` and
loads (run_PMR_ModCR.py:752-763).  The port's state dict already has that
layout, so the export selects the keys the JAX export writes, in its order,
as fp32 numpy arrays: ``np.savez(path, **sd)`` writes the same
``chunkalign_cls_state_dict.npz`` as the JAX two-stage script, and either
program's ``--stage1_npz`` reads the other's.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch
import torch.nn as nn

_LAYER_PARAMS = ("attention.self.query.", "attention.self.key.", "attention.self.value.",
                 "attention.output.dense.", "attention.output.LayerNorm.",
                 "intermediate.dense.", "output.dense.", "output.LayerNorm.")
_CLS_LAYER = ("cls_q_proj.", "align_k_proj.", "dense.", "LayerNorm.", "intermediate.dense.",
              "output.dense.", "output.LayerNorm.")
_PAIR = ("weight", "bias")


def _encoder_keys(prefix: str, num_layers: int) -> List[str]:
    """An image-text tower's keys in the JAX export's order (no image
    LayerNorm: the JAX export writes none)."""
    keys = [f"{prefix}embeddings.{n}_embeddings.weight"
            for n in ("word", "position", "token_type")]
    keys += [f"{prefix}embeddings.LayerNorm.{w}" for w in _PAIR]
    keys += [f"{prefix}img_embedding.{w}" for w in _PAIR]
    keys += [f"{prefix}encoder.layer.{i}.{name}{w}"
             for i in range(num_layers) for name in _LAYER_PARAMS for w in _PAIR]
    return keys + [f"{prefix}pooler.dense.{w}" for w in _PAIR]


def chunkalign_cls_keys(enc_cfg, *, cls_layer_num: int = 3) -> List[str]:
    """The keys of the JAX ``export_chunkalign_cls_state_dict``, in order."""
    n = enc_cfg.num_hidden_layers
    return (_encoder_keys("global_enc.", n) + _encoder_keys("seq_enc.", n)
            + ["seq_enc.edge_dense.weight"]
            + [f"{head}.{w}" for head in ("cls_ensemble", "classifier") for w in _PAIR]
            + [f"cls_layer.{i}.{name}{w}"
               for i in range(cls_layer_num) for name in _CLS_LAYER for w in _PAIR])


def export_chunkalign_cls_state_dict(
    model_or_sd: Union[nn.Module, Dict[str, torch.Tensor]], enc_cfg, *,
    cls_layer_num: int = 3,
) -> Dict[str, np.ndarray]:
    """A ``ChunkAlignClassifier`` (or its state dict) -> the reference
    ``ChunkAlign_CLS_enc4_align`` state dict as fp32 numpy arrays, with
    exactly the JAX export's keys; raises ``KeyError`` on a missing one."""
    sd = model_or_sd.state_dict() if isinstance(model_or_sd, nn.Module) else model_or_sd
    return {k: np.ascontiguousarray(sd[k].detach().float().cpu().numpy())
            for k in chunkalign_cls_keys(enc_cfg, cls_layer_num=cls_layer_num)}
