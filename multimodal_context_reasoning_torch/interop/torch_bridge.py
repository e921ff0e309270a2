"""Reference PyTorch/HuggingFace checkpoints -> the port's state-dict keys
(port of the part of the JAX package's ``interop/torch_bridge.py`` that the
ModCR import and the CLIP towers need).

The port's state dict already has the reference's composite layout
(``interop/from_jax.py``), so a tower's HF keys are its keys in the port
under the tower's prefix (``calec.global_enc.``, ``calec.seq_enc.``,
``roberta.``).  What is left of the JAX module's conversion is:

- ``strip_prefix``, ``delete_keys_matching`` (the cold-start surgery,
  run_PMR_ModCR.py:819-832) and ``load_torch_state_dict`` (the
  ``{'net': ...}`` wrapper, run_PMR_ModCR.py:236);
- ``resize_token_embeddings`` for the 45 ``<|det#|>`` rows
  (run_PMR_ModCR.py:715-716,730), with the JAX module's numpy draws;
- ``convert_bert_encoder`` and ``convert_roberta``: they pick a tower's
  keys out of a source dict (a ``bert.`` prefix stripped, the LayerNorm
  ``gamma``/``beta`` aliases renamed), resize its word embeddings, and for
  RoBERTa re-initialise the token-type table to 2 rows
  (run_PMR_ModCR.py:779-781).  They return flat ``{HF key: array}`` dicts
  where the JAX functions return Flax trees;
- ``load_clip_checkpoint`` and ``convert_clip`` (with ``_normalize_hf_clip``
  for HF ``CLIPModel`` keys): a CLIP checkpoint, OpenAI's or HF's, to the
  OpenAI layout that models/clip.py takes.

The GPT-2 converter is not ported: no path of the port loads a GPT-2
checkpoint.  Source dicts are flat ``{name: numpy array}``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

Array = np.ndarray
StateDict = Dict[str, Array]

# the HF keys of one BERT-family encoder layer (BertLayer)
_LAYER_KEYS = tuple(
    f"{module}.{leaf}"
    for module in ("attention.self.query", "attention.self.key", "attention.self.value",
                   "attention.output.dense", "attention.output.LayerNorm",
                   "intermediate.dense", "output.dense", "output.LayerNorm")
    for leaf in ("weight", "bias")
)


def load_torch_state_dict(path: str) -> StateDict:
    """torch.load a .pth/.bin file to a flat numpy dict (handles the
    reference's ``{'net': state_dict, ...}`` wrapper, run_PMR_ModCR.py:236).
    Only tensors and containers are unpickled (``weights_only``)."""
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "net" in raw and isinstance(raw["net"], dict):
        raw = raw["net"]
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).detach().numpy()
            for k, v in raw.items() if isinstance(v, torch.Tensor)}


def strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    """Keep only keys under ``prefix``, with it removed
    (run_PMR_ModCR.py:756-762 strips ``seq_enc.``)."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def delete_keys_matching(sd: StateDict, prefixes: Iterable[str]) -> StateDict:
    """Cold-start surgery (run_PMR_ModCR.py:823-832): drop freshly
    initialized heads before a non-strict load."""
    prefixes = tuple(prefixes)
    return {k: v for k, v in sd.items() if not k.startswith(prefixes)}


def resize_token_embeddings(
    emb: Array, new_size: int, *, std: float = 0.02, seed: int = 0
) -> Array:
    """Grow a [V, D] embedding table; new rows ~ N(0, std) (HF
    resize_token_embeddings semantics for the 45 <|det#|> tokens)."""
    V, D = emb.shape
    if new_size <= V:
        return emb[:new_size]
    rng = np.random.default_rng(seed)
    extra = (rng.standard_normal((new_size - V, D)) * std).astype(emb.dtype)
    return np.concatenate([emb, extra], axis=0)


def _get(sd: StateDict, *names: str) -> Optional[Array]:
    for n in names:
        if n in sd:
            return sd[n]
    return None


def _require(sd: StateDict, *names: str) -> Array:
    v = _get(sd, *names)
    if v is None:
        raise KeyError(f"none of {names} found in state dict "
                       f"(have e.g. {list(sd)[:5]})")
    return v


def _layers_and_pooler(sd: StateDict, num_layers: int, out: StateDict) -> StateDict:
    for i in range(num_layers):
        for key in _LAYER_KEYS:
            name = f"encoder.layer.{i}.{key}"
            out[name] = _require(sd, name)
    pw = _get(sd, "pooler.dense.weight")
    if pw is not None:
        out["pooler.dense.weight"] = pw
        out["pooler.dense.bias"] = _require(sd, "pooler.dense.bias")
    return out


def convert_bert_encoder(
    sd: StateDict,
    num_layers: int,
    *,
    vocab_size: Optional[int] = None,
    has_img_embedding: bool = True,
) -> StateDict:
    """HF-style BERT(+img_embedding) state dict -> one image encoder's keys
    (without the tower prefix).  Accepts both bare (``embeddings.…``) and
    ``bert.``-prefixed keys."""
    if any(k.startswith("bert.") for k in sd):
        sd = {**{k[5:]: v for k, v in sd.items() if k.startswith("bert.")},
              **{k: v for k, v in sd.items() if not k.startswith("bert.")}}

    word = _require(sd, "embeddings.word_embeddings.weight")
    if vocab_size is not None and word.shape[0] != vocab_size:
        word = resize_token_embeddings(word, vocab_size)
    out: StateDict = {
        "embeddings.word_embeddings.weight": word,
        "embeddings.position_embeddings.weight":
            _require(sd, "embeddings.position_embeddings.weight"),
        "embeddings.token_type_embeddings.weight":
            _require(sd, "embeddings.token_type_embeddings.weight"),
        "embeddings.LayerNorm.weight":
            _require(sd, "embeddings.LayerNorm.weight", "embeddings.LayerNorm.gamma"),
        "embeddings.LayerNorm.bias":
            _require(sd, "embeddings.LayerNorm.bias", "embeddings.LayerNorm.beta"),
    }
    if has_img_embedding:
        w = _get(sd, "img_embedding.weight")
        if w is not None:
            out["img_embedding.weight"] = w
            out["img_embedding.bias"] = _require(sd, "img_embedding.bias")
    return _layers_and_pooler(sd, num_layers, out)


def convert_roberta(
    sd: StateDict,
    num_layers: int,
    *,
    vocab_size: Optional[int] = None,
    reinit_token_types: int = 2,
    keep_token_type: bool = False,
    initializer_range: float = 0.02,
    seed: int = 0,
) -> StateDict:
    """HF roberta state dict -> PrefixRoberta's keys (without ``roberta.``).

    ``reinit_token_types``: the reference replaces roberta's 1-row
    token-type table with a fresh 2-row one (run_PMR_ModCR.py:779-781).
    ``keep_token_type``: restore the source table instead — required when
    loading a fine-tuned composite checkpoint whose 2-row table is trained
    (run_PMR_ModCR.py:802-806); the source must already have
    ``reinit_token_types`` rows.
    """
    if any(k.startswith("roberta.") for k in sd):
        sd = strip_prefix(sd, "roberta.")

    word = _require(sd, "embeddings.word_embeddings.weight")
    if vocab_size is not None and word.shape[0] != vocab_size:
        word = resize_token_embeddings(word, vocab_size)
    hidden = word.shape[1]

    if keep_token_type:
        ttype = _require(sd, "embeddings.token_type_embeddings.weight")
        if ttype.shape[0] != reinit_token_types:
            raise ValueError(
                f"keep_token_type: source table has {ttype.shape[0]} rows, "
                f"target needs {reinit_token_types}"
            )
    else:
        rng = np.random.default_rng(seed)
        ttype = (rng.standard_normal((reinit_token_types, hidden))
                 * initializer_range).astype(word.dtype)

    out: StateDict = {
        "embeddings.word_embeddings.weight": word,
        "embeddings.position_embeddings.weight":
            _require(sd, "embeddings.position_embeddings.weight"),
        "embeddings.token_type_embeddings.weight": ttype,
        "embeddings.LayerNorm.weight": _require(sd, "embeddings.LayerNorm.weight"),
        "embeddings.LayerNorm.bias": _require(sd, "embeddings.LayerNorm.bias"),
    }
    return _layers_and_pooler(sd, num_layers, out)


# the keys of one CLIP residual block, OpenAI's layout
_CLIP_BLOCK_KEYS = tuple(
    f"{module}.{leaf}"
    for module in ("ln_1", "attn.out_proj", "ln_2", "mlp.c_fc", "mlp.c_proj")
    for leaf in ("weight", "bias")
) + ("attn.in_proj_weight", "attn.in_proj_bias")


def _normalize_hf_clip(sd: StateDict) -> StateDict:
    """HF ``CLIPModel`` layout -> OpenAI layout (the one convert_clip reads).

    HF splits the fused in_proj into q/k/v and stores the projections as
    Linear ``[out, in]``; OpenAI packs ``in_proj_weight`` [3W, W] and keeps
    ``proj``/``text_projection`` as plain ``[in, out]`` matrices.
    """
    out: StateDict = {}

    def block(src_prefix: str, dst_prefix: str) -> None:
        i = 0
        while f"{src_prefix}.layers.{i}.layer_norm1.weight" in sd:
            s = f"{src_prefix}.layers.{i}."
            d = f"{dst_prefix}.resblocks.{i}."
            out[d + "ln_1.weight"] = sd[s + "layer_norm1.weight"]
            out[d + "ln_1.bias"] = sd[s + "layer_norm1.bias"]
            out[d + "attn.in_proj_weight"] = np.concatenate(
                [sd[s + f"self_attn.{n}_proj.weight"] for n in "qkv"], axis=0)
            out[d + "attn.in_proj_bias"] = np.concatenate(
                [sd[s + f"self_attn.{n}_proj.bias"] for n in "qkv"], axis=0)
            out[d + "attn.out_proj.weight"] = sd[s + "self_attn.out_proj.weight"]
            out[d + "attn.out_proj.bias"] = sd[s + "self_attn.out_proj.bias"]
            out[d + "ln_2.weight"] = sd[s + "layer_norm2.weight"]
            out[d + "ln_2.bias"] = sd[s + "layer_norm2.bias"]
            out[d + "mlp.c_fc.weight"] = sd[s + "mlp.fc1.weight"]
            out[d + "mlp.c_fc.bias"] = sd[s + "mlp.fc1.bias"]
            out[d + "mlp.c_proj.weight"] = sd[s + "mlp.fc2.weight"]
            out[d + "mlp.c_proj.bias"] = sd[s + "mlp.fc2.bias"]
            i += 1

    out["visual.conv1.weight"] = _require(
        sd, "vision_model.embeddings.patch_embedding.weight")
    out["visual.class_embedding"] = _require(
        sd, "vision_model.embeddings.class_embedding")
    out["visual.positional_embedding"] = _require(
        sd, "vision_model.embeddings.position_embedding.weight")
    # "pre_layrnorm" is HF's historical typo, kept for compatibility there.
    out["visual.ln_pre.weight"] = _require(
        sd, "vision_model.pre_layrnorm.weight", "vision_model.pre_layernorm.weight")
    out["visual.ln_pre.bias"] = _require(
        sd, "vision_model.pre_layrnorm.bias", "vision_model.pre_layernorm.bias")
    block("vision_model.encoder", "visual.transformer")
    out["visual.ln_post.weight"] = _require(sd, "vision_model.post_layernorm.weight")
    out["visual.ln_post.bias"] = _require(sd, "vision_model.post_layernorm.bias")
    out["visual.proj"] = np.ascontiguousarray(_require(sd, "visual_projection.weight").T)

    out["token_embedding.weight"] = _require(
        sd, "text_model.embeddings.token_embedding.weight")
    out["positional_embedding"] = _require(
        sd, "text_model.embeddings.position_embedding.weight")
    block("text_model.encoder", "transformer")
    out["ln_final.weight"] = _require(sd, "text_model.final_layer_norm.weight")
    out["ln_final.bias"] = _require(sd, "text_model.final_layer_norm.bias")
    out["text_projection"] = np.ascontiguousarray(_require(sd, "text_projection.weight").T)
    out["logit_scale"] = _require(sd, "logit_scale")
    return out


def convert_clip(sd: StateDict) -> StateDict:
    """CLIP checkpoint -> ``models/clip.py::CLIP``'s state dict, fp32 numpy.

    Accepts OpenAI's published layout (``visual.conv1.weight``,
    ``…resblocks.N.attn.in_proj_weight``, ``text_projection``, … — what
    ``clip.load('ViT-B/16')`` holds, run_PMR_ModCR.py:450) and HF's
    ``CLIPModel`` layout (``vision_model.…``, split q/k/v projections).
    Only the towers' keys are kept (OpenAI's archive also carries
    ``input_resolution``, ``context_length`` and ``vocab_size``); OpenAI
    ships fp16 weights, cast to fp32 here."""
    if "visual.conv1.weight" not in sd and \
            "vision_model.embeddings.patch_embedding.weight" in sd:
        sd = _normalize_hf_clip(sd)
    names = ["visual.conv1.weight", "visual.class_embedding",
             "visual.positional_embedding", "visual.ln_pre.weight", "visual.ln_pre.bias",
             "visual.ln_post.weight", "visual.ln_post.bias", "visual.proj",
             "token_embedding.weight", "positional_embedding", "ln_final.weight",
             "ln_final.bias", "text_projection"]
    for prefix in ("visual.transformer", "transformer"):
        i = 0
        while f"{prefix}.resblocks.{i}.ln_1.weight" in sd:
            names += [f"{prefix}.resblocks.{i}.{k}" for k in _CLIP_BLOCK_KEYS]
            i += 1
    out = {n: np.asarray(_require(sd, n), np.float32) for n in names}
    out["logit_scale"] = np.asarray(_require(sd, "logit_scale"), np.float32).reshape(())
    return out


def load_clip_checkpoint(path: str) -> StateDict:
    """OpenAI .pt (a TorchScript archive or a plain dict) or HF .bin -> flat
    numpy state dict for :func:`convert_clip`.  A plain file is unpickled
    tensors only (``weights_only``); a TorchScript archive is loaded with
    ``torch.jit.load``."""
    import torch

    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except RuntimeError:   # a TorchScript archive (weights_only refuses it)
        raw = torch.jit.load(path, map_location="cpu")
    if hasattr(raw, "state_dict"):
        raw = raw.state_dict()
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k: v.detach().cpu().float().numpy() for k, v in raw.items()
            if hasattr(v, "detach")}
