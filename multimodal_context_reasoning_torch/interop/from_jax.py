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

``chunkalign_cls_params_from_jax(tree, enc_cfg)`` maps a JAX
``ChunkAlignClassifier`` tree to the keys of the JAX package's
``interop/export.py:export_chunkalign_cls_state_dict``, and
``oscar_heads_params_from_jax`` a JAX ``models/oscar_heads.py`` head's.
``rationale_params_from_jax(tree, enc_cfg, gpt2_cfg)`` does the same for a
JAX ``RationaleModel`` tree, with the keys and values of the JAX package's
``interop/export.py:export_rationale_state_dict`` (the reference
``ChunkAlign_CLS_dec5_4`` layout): GPT-2 blocks in the vendored Conv1D
layout ([in, out], fused [in, 3D] ``attn.c_attn``, cross-attention
``q_attn`` and [in, 2D] ``c_attn``), the untied ``lm_head`` as
``nn.Linear``'s [vocab, D].  ``gpt2_params_from_jax`` maps a bare JAX
``GPT2Decoder`` tree the same way.

``dual_ensemble_params_from_jax(tree, cfg, text_view=...)`` maps a JAX
``DualEnsembleModel`` tree tower by tower (the same encoder, fusion,
RoBERTa and GPT-2 mappings, under the JAX tree's names),
``ensemble_params_from_jax`` a JAX ensemble head's, and
``clip_params_from_jax`` a JAX ``CLIP`` tree to OpenAI's layout.
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


def _fusion(out: StateDict, prefix: str, fusion: Dict[str, Any], cls_layer_num: int) -> None:
    """A JAX ``ChunkAlignFusion`` -> ``cls_ensemble_1`` and ``cls_layer_lyx``."""
    _lin(out, prefix + "cls_ensemble_1.", fusion["cls_ensemble_1"])
    for i in range(cls_layer_num):
        layer = fusion[f"cls_layer_{i}"]
        p = f"{prefix}cls_layer_lyx.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(out, f"{p}cross_attention.{proj}.", layer[proj])
        _ln(out, p + "LayerNorm.", layer["layer_norm"])
        _lin(out, p + "intermediate.dense.", layer["ffn"]["intermediate"])
        _lin(out, p + "output.dense.", layer["ffn"]["output"])
        _ln(out, p + "output.LayerNorm.", layer["ffn"]["output_layer_norm"])


def _roberta(out: StateDict, rob: Dict[str, Any], num_layers: int) -> None:
    """A JAX ``PrefixRoberta``, scanned or not -> ``roberta.*``."""
    if "layers" in rob:
        rob = unstack_layer_params(rob, num_layers)
    _encoder(out, "roberta.", rob, num_layers)


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

    _fusion(out, "calec.", root["fusion"], cfg.chunkalign.cls_layer_num)
    _roberta(out, root["roberta"], cfg.roberta.num_hidden_layers)

    # torch Sequential indices 1 / 4 are the mapping networks' two linears
    for name in ("mapping_network_vision", "mapping_network_alignment"):
        _lin(out, f"{name}.1.", root[name]["dense0"])
        _lin(out, f"{name}.4.", root[name]["dense1"])
    _lin(out, "abst_confidence_scorer.", root["abst_confidence_scorer"])
    if "promptfuse" in root:
        out["promptfuse"] = _t(root["promptfuse"])
    return out


def _conv1d(out: StateDict, prefix: str, *nodes: Dict[str, Any]) -> None:
    """Flax Dense kernels -> one vendored GPT-2 Conv1D ([in, out], no
    transpose), several kernels fused along the output axis."""
    out[prefix + "weight"] = _t(np.concatenate([np.asarray(n["kernel"]) for n in nodes], 1))
    out[prefix + "bias"] = _t(np.concatenate([np.asarray(n["bias"]) for n in nodes]))


def gpt2_params_from_jax(tree: Dict[str, Any], n_layer: int, prefix: str = "") -> StateDict:
    """JAX ``GPT2Decoder`` parameters -> the port's ``GPT2Decoder`` keys
    under ``prefix`` (an untied ``lm_head`` of the tree comes out as
    ``prefix + "lm_head.weight"``)."""
    dec = tree["params"] if "params" in tree else tree
    out: StateDict = {}
    out[prefix + "wte.weight"] = _t(dec["wte"]["embedding"])
    out[prefix + "wpe.weight"] = _t(dec["wpe"]["embedding"])
    _ln(out, prefix + "ln_f.", dec["ln_f"])
    if "lm_head" in dec:
        _lin(out, prefix + "lm_head.", dec["lm_head"])
    for i in range(n_layer):
        blk = dec[f"block_{i}"]
        p = f"{prefix}h.{i}."
        _ln(out, p + "ln_1.", blk["ln_1"])
        _ln(out, p + "ln_2.", blk["ln_2"])
        att = blk["attn"]
        _conv1d(out, p + "attn.c_attn.", att["q"], att["k"], att["v"])
        _conv1d(out, p + "attn.c_proj.", att["out"])
        _conv1d(out, p + "mlp.c_fc.", blk["mlp_c_fc"])
        _conv1d(out, p + "mlp.c_proj.", blk["mlp_c_proj"])
        if "crossattention" in blk:
            ca = blk["crossattention"]
            _conv1d(out, p + "crossattention.q_attn.", ca["q"])
            _conv1d(out, p + "crossattention.c_attn.", ca["k"], ca["v"])
            _conv1d(out, p + "crossattention.c_proj.", ca["out"])
            _ln(out, p + "ln_cross_attn.", blk["ln_cross"])
    return out


def chunkalign_cls_params_from_jax(tree: Dict[str, Any], enc_cfg, *,
                                   cls_layer_num: int = 3) -> StateDict:
    """JAX ``ChunkAlignClassifier`` parameter tree -> the port's
    ``ChunkAlignClassifier`` state dict (fp32, CPU): the keys and values of
    the JAX package's ``interop/export.py:export_chunkalign_cls_state_dict``
    (the reference ``ChunkAlign_CLS_enc4_align`` layout)."""
    root = tree["params"] if "params" in tree else tree
    out: StateDict = {}
    _encoder(out, "global_enc.", root["global_enc"], enc_cfg.num_hidden_layers)
    _encoder(out, "seq_enc.", root["seq_enc"], enc_cfg.num_hidden_layers)
    out["seq_enc.edge_dense.weight"] = _t(root["seq_enc"]["edge_dense"])
    _lin(out, "cls_ensemble.", root["cls_ensemble"])
    _lin(out, "classifier.", root["classifier"])
    for i in range(cls_layer_num):
        layer = root[f"cls_layer_{i}"]
        p = f"cls_layer.{i}."
        for name in ("cls_q_proj", "align_k_proj", "dense"):
            _lin(out, f"{p}{name}.", layer[name])
        _ln(out, p + "LayerNorm.", layer["layer_norm"])
        _lin(out, p + "intermediate.dense.", layer["ffn"]["intermediate"])
        _lin(out, p + "output.dense.", layer["ffn"]["output"])
        _ln(out, p + "output.LayerNorm.", layer["ffn"]["output_layer_norm"])
    return out


def rationale_params_from_jax(tree: Dict[str, Any], enc_cfg, gpt2_cfg, *,
                              cls_layer_num: int = 3) -> StateDict:
    """JAX ``RationaleModel`` parameter tree -> the port's
    ``RationaleModel`` state dict (fp32, CPU): the classifier's keys, then
    the decoder's."""
    root = tree["params"] if "params" in tree else tree
    out = chunkalign_cls_params_from_jax(root, enc_cfg, cls_layer_num=cls_layer_num)
    dec = gpt2_params_from_jax(root["dec"], gpt2_cfg.n_layer, "dec.")
    out["lm_head.weight"] = dec.pop("dec.lm_head.weight")
    out.update(dec)
    return out


def oscar_heads_params_from_jax(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    """A JAX head's parameter tree -> the port head's state dict (fp32,
    CPU), its keys under ``prefix``: every Dense by its Flax name (kernel
    transposed), every LayerNorm likewise, bare parameters as they are,
    nested modules under their names.  For the ``models/oscar_heads.py``
    heads: the transform's LayerNorm as ``transform_layer_norm``,
    ``decoder_bias`` as it is, ``predictions`` nested; for the ensemble
    heads: ``classifier``, ``classifier_<view>``, ``vote`` and
    ``easy_fusion`` as ``nn.Linear``, ``view_gates`` as it is."""
    root = tree["params"] if "params" in tree else tree
    out: StateDict = {}

    def walk(node: Dict[str, Any], prefix: str) -> None:
        for name, child in node.items():
            if not isinstance(child, dict):
                out[prefix + name] = _t(child)
            elif "kernel" in child:
                _lin(out, f"{prefix}{name}.", child)
            elif "scale" in child:
                _ln(out, f"{prefix}{name}.", child)
            else:
                walk(child, f"{prefix}{name}.")

    walk(root, prefix)
    return out


# A JAX ``CandidateEnsemble`` or ``VoteEnsemble`` (or a CLIP head of
# ``models/clip_ensemble.py``) maps as the Oscar heads do.
ensemble_params_from_jax = oscar_heads_params_from_jax


def dual_ensemble_params_from_jax(tree: Dict[str, Any], cfg: ModCRConfig, *,
                                  text_view: str = "roberta") -> StateDict:
    """JAX ``DualEnsembleModel`` parameter tree -> the port's state dict
    (fp32, CPU): the towers under ``global_enc.``, ``seq_enc.``,
    ``fusion.``, ``roberta.`` or ``gpt.`` (the vendored GPT-2 layout), the
    head under ``ensemble.``."""
    root = tree["params"] if "params" in tree else tree
    out: StateDict = {}
    _encoder(out, "global_enc.", root["global_enc"], cfg.global_encoder.num_hidden_layers)
    _encoder(out, "seq_enc.", root["seq_enc"], cfg.seq_encoder.num_hidden_layers)
    out["seq_enc.edge_dense.weight"] = _t(root["seq_enc"]["edge_dense"])
    _fusion(out, "fusion.", root["fusion"], cfg.chunkalign.cls_layer_num)
    if text_view == "gpt2":
        gpt = root["gpt"]
        n_layer = sum(1 for k in gpt if k.startswith("block_"))
        out.update(gpt2_params_from_jax(gpt, n_layer, "gpt."))
    else:
        _roberta(out, root["roberta"], cfg.roberta.num_hidden_layers)
    out.update(oscar_heads_params_from_jax(root["ensemble"], "ensemble."))
    return out


def clip_params_from_jax(tree: Dict[str, Any]) -> StateDict:
    """JAX ``models/clip.py::CLIP`` parameter tree -> the port's ``CLIP``
    state dict, OpenAI's layout (fp32, CPU): the Flax HWIO conv kernel to
    torch's OIHW, fused ``in_proj`` kernels [W, 3W] to ``in_proj_weight``
    [3W, W], the projections kept [in, out]."""
    root = tree["params"] if "params" in tree else tree
    out: StateDict = {}

    def blocks(prefix: str, tower: Dict[str, Any]) -> None:
        i = 0
        while f"block_{i}" in tower:
            blk, p = tower[f"block_{i}"], f"{prefix}resblocks.{i}."
            _ln(out, p + "ln_1.", blk["ln_1"])
            out[p + "attn.in_proj_weight"] = _t(np.asarray(blk["in_proj"]["kernel"]).T)
            out[p + "attn.in_proj_bias"] = _t(blk["in_proj"]["bias"])
            _lin(out, p + "attn.out_proj.", blk["out_proj"])
            _ln(out, p + "ln_2.", blk["ln_2"])
            _lin(out, p + "mlp.c_fc.", blk["mlp_c_fc"])
            _lin(out, p + "mlp.c_proj.", blk["mlp_c_proj"])
            i += 1

    vis = root["visual"]
    out["visual.conv1.weight"] = _t(np.asarray(vis["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    for name in ("class_embedding", "positional_embedding", "proj"):
        out["visual." + name] = _t(vis[name])
    _ln(out, "visual.ln_pre.", vis["ln_pre"])
    _ln(out, "visual.ln_post.", vis["ln_post"])
    blocks("visual.transformer.", vis)
    txt = root["text"]
    out["token_embedding.weight"] = _t(txt["token_embedding"]["embedding"])
    out["positional_embedding"] = _t(txt["positional_embedding"])
    out["text_projection"] = _t(txt["text_projection"])
    _ln(out, "ln_final.", txt["ln_final"])
    blocks("transformer.", txt)
    out["logit_scale"] = _t(root["logit_scale"]).reshape(())
    return out
