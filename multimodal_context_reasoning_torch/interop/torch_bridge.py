"""Reference PyTorch/HuggingFace checkpoints -> the port's state-dict keys
(port of the part of the JAX package's ``interop/torch_bridge.py`` that the
ModCR import needs).

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
  where the JAX functions return Flax trees.

The GPT-2 and CLIP converters are not ported yet (ROADMAP).  Source dicts
are flat ``{name: numpy array}``.
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
