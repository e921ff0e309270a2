"""JAX ModCR parameters -> the port's ``state_dict``.

``params_from_jax(tree, cfg)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, variables)``) and
returns the state dict ``ModCRModel.load_state_dict(sd, strict=True)``
takes.  Its keys are the reference's full-composite layout, the same keys
``interop/export.py:export_modcr_state_dict`` of the JAX package emits (this
module keeps its own copy of that mapping): Dense kernels are transposed to
``nn.Linear``'s [out, in], LayerNorm ``scale`` becomes ``weight``.  Beyond
that mapping it carries ``calec.seq_enc.edge_dense.weight``, the image
LayerNorm when the config has one, the ``promptfuse`` prefix of that
ablation, and unstacks a scanned RoBERTa tree (``layers/layer/<leaf>`` with a
leading [N] axis) into per-layer keys.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from multimodal_context_reasoning_torch.core.config import ModCRConfig

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(out: StateDict, prefix: str, node: Dict[str, Any]) -> None:
    """Flax Dense -> torch Linear (kernel transposed to [out, in])."""
    out[prefix + "weight"] = _t(np.asarray(node["kernel"]).T)
    if "bias" in node:
        out[prefix + "bias"] = _t(node["bias"])


def _ln(out: StateDict, prefix: str, node: Dict[str, Any]) -> None:
    out[prefix + "weight"] = _t(node["scale"])
    out[prefix + "bias"] = _t(node["bias"])


def unstack_layer_params(tower: Dict[str, Any], num_layers: int) -> Dict[str, Any]:
    """Scanned PrefixRoberta params (``layers/layer/<leaf>``, leading [N]
    axis) -> per-layer ``layer_i`` subtrees."""
    out = {k: v for k, v in tower.items() if k != "layers"}
    stacked = tower["layers"]["layer"]

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    for i in range(num_layers):
        out[f"layer_{i}"] = take(stacked, i)
    return out


def _encoder(out: StateDict, prefix: str, tree: Dict[str, Any], num_layers: int) -> None:
    """One BERT-family tower -> HF-style keys under ``prefix``."""
    if "img_text_embeddings" in tree:
        ite = tree["img_text_embeddings"]
        emb = ite["embeddings"]
        _lin(out, prefix + "img_embedding.", ite["img_embedding"])
        if "img_layer_norm" in ite:
            _ln(out, prefix + "img_layer_norm.", ite["img_layer_norm"])
    else:
        emb = tree["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"{prefix}embeddings.{name}.weight"] = _t(emb[name]["embedding"])
    _ln(out, prefix + "embeddings.LayerNorm.", emb["layer_norm"])
    for i in range(num_layers):
        layer = tree[f"layer_{i}"]
        p = f"{prefix}encoder.layer.{i}."
        att = layer["attention"]
        _lin(out, p + "attention.self.query.", att["query"])
        _lin(out, p + "attention.self.key.", att["key"])
        _lin(out, p + "attention.self.value.", att["value"])
        _lin(out, p + "attention.output.dense.", att["out"])
        _ln(out, p + "attention.output.LayerNorm.", att["out_layer_norm"])
        ffn = layer["ffn"]
        _lin(out, p + "intermediate.dense.", ffn["intermediate"])
        _lin(out, p + "output.dense.", ffn["output"])
        _ln(out, p + "output.LayerNorm.", ffn["output_layer_norm"])
    _lin(out, prefix + "pooler.dense.", tree["pooler"]["dense"])


def params_from_jax(tree: Dict[str, Any], cfg: ModCRConfig) -> StateDict:
    """JAX ModCR parameter tree -> the port's state dict (fp32, CPU)."""
    root = tree["params"] if "params" in tree else tree
    out: StateDict = {}

    _encoder(out, "calec.global_enc.", root["global_enc"],
             cfg.global_encoder.num_hidden_layers)
    if "seq_enc" in root:
        _encoder(out, "calec.seq_enc.", root["seq_enc"],
                 cfg.seq_encoder.num_hidden_layers)
        out["calec.seq_enc.edge_dense.weight"] = _t(root["seq_enc"]["edge_dense"])

    fusion = root["fusion"]
    _lin(out, "calec.cls_ensemble_1.", fusion["cls_ensemble_1"])
    for i in range(cfg.chunkalign.cls_layer_num):
        layer = fusion[f"cls_layer_{i}"]
        p = f"calec.cls_layer_lyx.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(out, f"{p}cross_attention.{proj}.", layer[proj])
        _ln(out, p + "LayerNorm.", layer["layer_norm"])
        _lin(out, p + "intermediate.dense.", layer["ffn"]["intermediate"])
        _lin(out, p + "output.dense.", layer["ffn"]["output"])
        _ln(out, p + "output.LayerNorm.", layer["ffn"]["output_layer_norm"])

    rob = root["roberta"]
    if "layers" in rob:
        rob = unstack_layer_params(rob, cfg.roberta.num_hidden_layers)
    _encoder(out, "roberta.", rob, cfg.roberta.num_hidden_layers)

    # torch Sequential indices 1 / 4 are the mapping networks' two linears
    for name in ("mapping_network_vision", "mapping_network_alignment"):
        _lin(out, f"{name}.1.", root[name]["dense0"])
        _lin(out, f"{name}.4.", root[name]["dense1"])
    _lin(out, "abst_confidence_scorer.", root["abst_confidence_scorer"])
    if "promptfuse" in root:
        out["promptfuse"] = _t(root["promptfuse"])
    return out
