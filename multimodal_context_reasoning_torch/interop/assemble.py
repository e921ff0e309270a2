"""One-call import of the reference's checkpoints into the port's ModCR
state dict (port of the JAX package's ``interop/assemble.py``).

Mirrors the reference's model-build sequence (run_PMR_ModCR.py:709-835):

1. Oscar-base ``BertImgModel`` weights -> global encoder (:727-730), with the
   45 ``<|det#|>`` token rows appended (:715-716,730);
2. ChunkAlign pretrain dict: strip the ``seq_enc.`` prefix, load into the
   sequence encoder (:752-763);
3. ``roberta-large`` -> prefix reasoner, token-type table re-initialised to
   2 rows (:772-781);
4. optional ModCR checkpoint (the ``{'net': ...}`` torch.save form,
   :236-239), a **full composite** ``Abstract_Specific`` state dict
   (run_PMR_ModCR.py:802-806) or a heads-only one.  ``cold_start`` deletes
   its ``mapping_network_vision.`` / ``mapping_network_alignment.`` /
   ``classifier.`` keys before the load (:819-832), so those heads keep
   their fresh init.

:func:`assemble_rationale_params` grafts a reference ``ChunkAlign_CLS_dec5_4``
checkpoint (the rationale family, v10.py:1319-1494) into the port's
``RationaleModel`` state dict, with the JAX function's report, and
:func:`load_rationale_checkpoint` builds the model for it with the GPT-2
vocabulary sized to the checkpoint's ``dec.wte.weight`` rows, as the JAX
serve command does (cli/serve.py:287-303).

The port's keys are the reference's composite layout, so every graft is a
copy of source keys onto the same names under a tower prefix, with a shape
check (the JAX package builds Flax trees instead).  As there, every call
returns an :class:`AssembleReport` accounting for EVERY source key —
consumed, skipped with a documented reason (the reference's dead heads), or
unexpectedly unconsumed (an error when ``strict``), with the same counts as
the JAX function on the same sources.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Set

import numpy as np
import torch

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.interop.torch_bridge import (
    StateDict,
    convert_bert_encoder,
    convert_roberta,
    delete_keys_matching,
    load_torch_state_dict,
)

COLD_START_DROPPED = (
    "mapping_network_vision.",
    "mapping_network_alignment.",
    "classifier.",
)

# Abstract_Specific / CALeC parameters that exist in every reference
# checkpoint but are never read by the production forward — each entry is
# (prefix, reason with reference citation).  Keys under these prefixes are
# reported as skipped, not errors.
_KNOWN_DEAD = (
    ("calec.cls_layer.", "ClsLayer2 stack constructed but prod forward uses "
                         "cls_layer_lyx only (v10.py:884-885,976-977)"),
    ("calec.classifier.", "dead CALeC head (v10.py:886, return path commented "
                          "out :999-1013)"),
    ("calec.fusion_align.", "dead CALeC head (v10.py:887; consumer block is "
                            "commented out :920-941)"),
    ("calec.prior.", "dead CALeC head (v10.py:889; prior_score path commented "
                     "out :942,968)"),
    ("classifier.", "dead Abstract_Specific head (ensemble:432-435; logits "
                    "path commented out :508-510)"),
    ("confidence_scorer.", "dead Abstract_Specific head (ensemble:438; "
                           "specific_logits commented out :510)"),
    ("promptfuse.", "PromptFuse ablation embedding, unused in prod forward "
                    "(ensemble:458, usage commented :477-481)"),
)
# Within each cls_layer_lyx block: the BertLayer base attention and two dead
# heads (ClsLayer_lyx.forward reads only cross_attention/LayerNorm/
# intermediate/output, v10.py:857-870).
_CLS_LYX_DEAD = ("attention.", "ensemble.", "dense.")
# the keys of one CALeC reasoning layer (ClsLayer_lyx) that its forward reads
_CLS_LYX_LINEARS = ("cross_attention.q_proj.", "cross_attention.k_proj.",
                    "cross_attention.v_proj.", "cross_attention.out_proj.",
                    "intermediate.dense.", "output.dense.")
_CLS_LYX_NORMS = ("LayerNorm.", "output.LayerNorm.")
_HEADS = ("mapping_network_vision.1.", "mapping_network_vision.4.",
          "mapping_network_alignment.1.", "mapping_network_alignment.4.",
          "abst_confidence_scorer.")


class _TrackedSD(dict):
    """Flat state dict recording every key actually read (by its ORIGINAL
    checkpoint name, surviving prefix-stripping views).

    The converters read via ``sd[name]`` after an ``in`` check, so
    ``__getitem__`` is the single consumption point.
    """

    def __init__(self, base: Dict[str, Any], consumed: Optional[Set[str]] = None,
                 names: Optional[Dict[str, str]] = None):
        super().__init__(base)
        self.consumed: Set[str] = consumed if consumed is not None else set()
        self.names: Dict[str, str] = names or {}

    def full_name(self, key: str) -> str:
        return self.names.get(key, key)

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.consumed.add(self.full_name(key))
        return value

    def sub(self, prefix: str) -> "_TrackedSD":
        """Tracked view of the keys under ``prefix`` (names recorded in
        full)."""
        base: Dict[str, Any] = {}
        names: Dict[str, str] = {}
        for k in dict.keys(self):
            if k.startswith(prefix):
                bare = k[len(prefix):]
                base[bare] = dict.__getitem__(self, k)
                names[bare] = self.full_name(k)
        return _TrackedSD(base, self.consumed, names)


@dataclasses.dataclass
class AssembleReport:
    """Per-source-key accounting for one checkpoint graft."""

    consumed: Set[str] = dataclasses.field(default_factory=set)
    skipped: Dict[str, str] = dataclasses.field(default_factory=dict)  # key -> reason
    unconsumed: Set[str] = dataclasses.field(default_factory=set)

    def summary(self) -> str:
        lines = [
            f"consumed={len(self.consumed)} skipped={len(self.skipped)} "
            f"unconsumed={len(self.unconsumed)}"
        ]
        for k in sorted(self.unconsumed):
            lines.append(f"  UNCONSUMED: {k}")
        return "\n".join(lines)


def _finish(report: AssembleReport, sd: _TrackedSD, strict: bool, extra=()) -> None:
    """Classify leftovers: known-dead prefixes (and the caller's ``extra``
    ``(regex, reason)`` pairs, tried first) -> skipped, rest ->
    unconsumed."""
    report.consumed |= sd.consumed
    for key in sd:
        full = sd.full_name(key)
        if full in report.consumed or full in report.skipped:
            continue
        reason = next((why for pattern, why in extra if re.search(pattern, key)), None)
        if reason is None and key.endswith(".position_ids") or key == "position_ids":
            reason = "HF position-id buffer (not a parameter)"
        if reason is None:
            for prefix, why in _KNOWN_DEAD:
                if key.startswith(prefix):
                    reason = why
                    break
            if reason is None and re.match(
                r"calec\.cls_layer_lyx\.\d+\.(%s)"
                % "|".join(re.escape(p) for p in _CLS_LYX_DEAD), key
            ):
                reason = ("BertLayer base attention / dead heads inside "
                          "ClsLayer_lyx (forward reads only cross_attention/"
                          "LayerNorm/intermediate/output, v10.py:857-870)")
        if reason is not None:
            report.skipped[full] = reason
        else:
            report.unconsumed.add(full)
    if strict and report.unconsumed:
        raise KeyError(
            "checkpoint keys were neither grafted nor known-dead:\n"
            + "\n".join(f"  {k}" for k in sorted(report.unconsumed))
        )


def _merge(params: Dict[str, torch.Tensor], prefix: str, flat: StateDict) -> None:
    """Copy ``flat`` onto ``params[prefix + key]`` as fp32 CPU tensors,
    checking that every target exists and every shape matches (the
    non-strict-load analogue: target keys not in ``flat`` keep their
    values)."""
    for key, value in flat.items():
        name = prefix + key
        if name not in params:
            raise KeyError(f"no target param {name}")
        if tuple(params[name].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name}: "
                             f"{tuple(params[name].shape)} vs {tuple(value.shape)}")
        params[name] = torch.from_numpy(np.array(value, dtype=np.float32))


def _linear(sd: _TrackedSD, prefix: str) -> StateDict:
    out = {prefix + "weight": sd[prefix + "weight"]}
    if prefix + "bias" in sd:
        out[prefix + "bias"] = sd[prefix + "bias"]
    return out


def _graft_encoder(params, sd: _TrackedSD, target: str, cfg_enc) -> None:
    # Normalize a "bert."-prefixed dict here (the converter would otherwise
    # rebuild a plain dict and lose consumption tracking).
    if any(k.startswith("bert.") for k in sd):
        base: Dict[str, Any] = {}
        names: Dict[str, str] = {}
        for k in list(dict.keys(sd)):
            if k.startswith("bert."):
                base[k[5:]] = dict.__getitem__(sd, k)
                names[k[5:]] = sd.full_name(k)
        for k in list(dict.keys(sd)):            # bare keys win on collision
            if not k.startswith("bert."):
                base[k] = dict.__getitem__(sd, k)
                names[k] = sd.full_name(k)
        sd = _TrackedSD(base, sd.consumed, names)
    _merge(params, target, convert_bert_encoder(
        sd, cfg_enc.num_hidden_layers, vocab_size=cfg_enc.vocab_size))


def _graft_seq_encoder(params, sd: _TrackedSD, cfg_enc, target: str = "calec.seq_enc.") -> None:
    _graft_encoder(params, sd, target, cfg_enc)
    # SeqBertImgModel's extra edge_dense embedding (v10.py:260) — unused by
    # forward but a real checkpoint key; keep it for round-trip fidelity.
    if "edge_dense.weight" in sd:
        _merge(params, target, {"edge_dense.weight": sd["edge_dense.weight"]})


def _graft_roberta(params, sd: _TrackedSD, cfg: ModCRConfig,
                   report: AssembleReport, *, keep_token_type: bool = False) -> None:
    if any(k.startswith("roberta.") for k in sd):
        sd = sd.sub("roberta.")                   # keep tracking through strip
    if not keep_token_type and "embeddings.token_type_embeddings.weight" in sd:
        # the reference replaces the pretrained table with a fresh 2-row one
        report.skipped[
            sd.full_name("embeddings.token_type_embeddings.weight")
        ] = ("token-type table re-initialised to 2 rows "
             "(run_PMR_ModCR.py:779-781)")
    _merge(params, "roberta.", convert_roberta(
        sd, cfg.roberta.num_hidden_layers, vocab_size=cfg.roberta.vocab_size,
        reinit_token_types=cfg.roberta.type_vocab_size, keep_token_type=keep_token_type))


def _graft_fusion(params, sd: _TrackedSD, cfg: ModCRConfig) -> None:
    """CALeC fusion stack: cls_ensemble_1 + cls_layer_lyx.N (v10.py:877,885)."""
    flat: StateDict = {}
    if "calec.cls_ensemble_1.weight" in sd:
        flat.update(_linear(sd, "calec.cls_ensemble_1."))
    for i in range(cfg.chunkalign.cls_layer_num):
        p = f"calec.cls_layer_lyx.{i}."
        if p + "cross_attention.q_proj.weight" not in sd:
            continue
        for name in _CLS_LYX_LINEARS:
            flat.update(_linear(sd, p + name))
        for name in _CLS_LYX_NORMS:
            flat[p + name + "weight"] = sd[p + name + "weight"]
            flat[p + name + "bias"] = sd[p + name + "bias"]
    _merge(params, "", flat)


def _graft_heads(params, sd: _TrackedSD) -> None:
    """Mapping networks (torch Sequential indices 1/4) + scorer
    (ensemble:439-457,437)."""
    flat: StateDict = {}
    for prefix in _HEADS:
        if prefix + "weight" in sd:
            flat.update(_linear(sd, prefix))
    _merge(params, "", flat)


def assemble_modcr_params(
    params: Dict[str, torch.Tensor],
    cfg: ModCRConfig,
    *,
    oscar_sd: Optional[StateDict] = None,
    chunkalign_sd: Optional[StateDict] = None,
    roberta_sd: Optional[StateDict] = None,
    modcr_sd: Optional[StateDict] = None,
    cold_start: bool = False,
    strict: bool = True,
) -> AssembleReport:
    """Graft converted reference weights into the port's state dict
    ``params`` (a ``model.state_dict()``), in place: each grafted entry is
    replaced by a CPU fp32 tensor, so load the dict back with
    ``model.load_state_dict(params)``.  Any source may be omitted (its
    submodel keeps its values — the non-strict-load semantics).

    ``modcr_sd`` may be a heads-only dict or a **full** ``Abstract_Specific``
    state dict (run_PMR_ModCR.py:802-806); the full form restores the
    fine-tuned CALeC fusion stack, both encoders, and RoBERTa too.

    ``cold_start=True`` reproduces the stage-1 surgery
    (run_PMR_ModCR.py:819-832): the mapping networks and scorer keys of
    ``modcr_sd`` are dropped so those heads keep their fresh init; False
    (evaluation / resume) grafts them too.

    Returns an :class:`AssembleReport`; with ``strict=True`` (default) any
    source key that is neither grafted nor known-dead raises.
    """
    report = AssembleReport()

    if oscar_sd is not None:
        sd = _TrackedSD(oscar_sd)
        _graft_encoder(params, sd, "calec.global_enc.", cfg.global_encoder)
        _finish(report, sd, strict)

    if chunkalign_sd is not None:
        sd = _TrackedSD(chunkalign_sd)
        if any(k.startswith("seq_enc.") for k in sd):
            sd = sd.sub("seq_enc.")             # run_PMR_ModCR.py:756-762
        _graft_seq_encoder(params, sd, cfg.seq_encoder)
        _finish(report, sd, strict)

    if roberta_sd is not None:
        sd = _TrackedSD(roberta_sd)
        _graft_roberta(params, sd, cfg, report)
        _finish(report, sd, strict)

    if modcr_sd is not None:
        sd_raw = modcr_sd
        if cold_start:
            # stage-1 surgery (:819-832): heads stay freshly initialized
            dropped = [k for k in sd_raw if k.startswith(COLD_START_DROPPED)]
            sd_raw = delete_keys_matching(sd_raw, COLD_START_DROPPED)
            for k in dropped:
                report.skipped[k] = ("cold-start surgery deletes this key "
                                     "before the non-strict load "
                                     "(run_PMR_ModCR.py:819-832)")
        sd = _TrackedSD(sd_raw)
        if any(k.startswith("calec.") for k in sd):
            _graft_encoder(params, sd.sub("calec.global_enc."),
                           "calec.global_enc.", cfg.global_encoder)
            _graft_seq_encoder(params, sd.sub("calec.seq_enc."), cfg.seq_encoder)
            _graft_fusion(params, sd, cfg)
        if any(k.startswith("roberta.") for k in sd):
            # fine-tuned reasoner inside the composite: keep its trained
            # 2-row token-type table instead of re-initialising
            _graft_roberta(params, sd.sub("roberta."), cfg, report,
                           keep_token_type=True)
        _graft_heads(params, sd)
        _finish(report, sd, strict)

    return report


# the keys of one rationale reasoning layer (ClsLayer2) that its forward reads
_CLS_REASON_LINEARS = ("cls_q_proj.", "align_k_proj.", "dense.", "intermediate.dense.",
                       "output.dense.")
_CLS_REASON_NORMS = ("LayerNorm.", "output.LayerNorm.")
# the keys of one vendored GPT-2 block, Conv1D and LayerNorm weight/bias pairs
_GPT2_BLOCK = ("ln_1.", "attn.c_attn.", "attn.c_proj.", "ln_2.", "mlp.c_fc.", "mlp.c_proj.")
_GPT2_CROSS = ("crossattention.q_attn.", "crossattention.c_attn.",
               "crossattention.c_proj.", "ln_cross_attn.")
_RATIONALE_LEFTOVERS = (
    (r"^dec\.h\.\d+\.(crossattention|attn)\.(bias|masked_bias)$",
     "GPT-2 causal-mask buffer, not a parameter "
     "(modeling_transfomres.py Attention.register_buffer)"),
    (r"^cls_layer\.\d+\.attention\.",
     "dead BertSelfAttention inside ClsLayer2 — its forward reads "
     "only cls_q_proj/align_k_proj/dense/LayerNorm/FFN "
     "(v10.py:801-837)"),
)


def assemble_rationale_params(
    params: Dict[str, torch.Tensor],
    enc_cfg,
    gpt2_cfg,
    rationale_sd: StateDict,
    *,
    cls_layer_num: int = 3,
    strict: bool = True,
) -> AssembleReport:
    """Graft a reference ``ChunkAlign_CLS_dec5_4`` state dict into the
    port's ``RationaleModel`` state dict ``params``, in place (the JAX
    ``assemble_rationale_params``): ``global_enc.*`` / ``seq_enc.*`` (the
    word embeddings resized to ``enc_cfg.vocab_size``, ``edge_dense``
    kept), ``cls_ensemble`` and ``classifier``, ``cls_layer.N.*``, the
    vendored GPT-2 ``dec.*`` (a block's cross-attention keys where the
    checkpoint has them) and the untied ``lm_head``.  The GPT-2 causal-mask
    buffers and ClsLayer2's dead attention are reported as skipped."""
    report = AssembleReport()
    sd = _TrackedSD(rationale_sd)
    _graft_encoder(params, sd.sub("global_enc."), "global_enc.", enc_cfg)
    _graft_seq_encoder(params, sd.sub("seq_enc."), enc_cfg, target="seq_enc.")
    flat: StateDict = {}
    flat.update(_linear(sd, "cls_ensemble."))
    flat.update(_linear(sd, "classifier."))
    for i in range(cls_layer_num):
        p = f"cls_layer.{i}."
        for name in _CLS_REASON_LINEARS:
            flat.update(_linear(sd, p + name))
        for name in _CLS_REASON_NORMS:
            flat.update(_linear(sd, p + name))
    for name in ("dec.wte.weight", "dec.wpe.weight", "lm_head.weight"):
        flat[name] = sd[name]
    flat.update(_linear(sd, "dec.ln_f."))
    for i in range(gpt2_cfg.n_layer):
        p = f"dec.h.{i}."
        cross = _GPT2_CROSS if p + "crossattention.c_attn.weight" in sd else ()
        for name in _GPT2_BLOCK + cross:
            flat.update(_linear(sd, p + name))
    _merge(params, "", flat)
    _finish(report, sd, strict, extra=_RATIONALE_LEFTOVERS)
    return report


def load_rationale_checkpoint(path: str, enc_cfg, schedule, gpt2_cfg, *, max_chunks: int,
                              device, generator: Optional[torch.Generator] = None):
    """A reference rationale ``.pth`` -> ``(RationaleModel, GPT2Config,
    AssembleReport)``.  The reference adds the rationale markers to its
    GPT-2 vocabulary, so a trained checkpoint's embedding rows fix the
    config's ``vocab_size``, not the other way round."""
    from multimodal_context_reasoning_torch.models.rationale import RationaleModel

    sd = load_torch_state_dict(path)
    rows = sd["dec.wte.weight"].shape[0]
    gpt2_cfg = dataclasses.replace(gpt2_cfg, vocab_size=rows)
    model = RationaleModel(enc_cfg, schedule, gpt2_cfg, max_chunks=max_chunks, device=device,
                           generator=generator)
    params = dict(model.state_dict())
    report = assemble_rationale_params(params, enc_cfg, gpt2_cfg, sd)
    model.load_state_dict(params, strict=True)
    return model, gpt2_cfg, report


def assemble_from_files(
    params: Dict[str, torch.Tensor],
    cfg: ModCRConfig,
    *,
    oscar_path: Optional[str] = None,
    chunkalign_path: Optional[str] = None,
    roberta_path: Optional[str] = None,
    modcr_path: Optional[str] = None,
    cold_start: bool = False,
    strict: bool = True,
) -> AssembleReport:
    """:func:`assemble_modcr_params` from checkpoint files (``torch.load``)."""
    load = lambda p: load_torch_state_dict(p) if p else None
    return assemble_modcr_params(
        params, cfg,
        oscar_sd=load(oscar_path),
        chunkalign_sd=load(chunkalign_path),
        roberta_sd=load(roberta_path),
        modcr_sd=load(modcr_path),
        cold_start=cold_start,
        strict=strict,
    )
