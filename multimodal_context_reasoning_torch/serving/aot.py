"""AOT serving artifacts: a scorer and a greedy generator stood up from a
directory without constructing a model (port of the JAX package's
``serving/aot.py``).

``save_scorer_artifact`` exports a warmed :class:`ModCRScorer`'s fixed-shape
forward with ``torch.export``: a function ``(params, batch) -> logits`` that
runs the scorer's module through ``torch.func.functional_call``, so the
weights are program *inputs* and the ``.pt2`` program holds shapes only.
:class:`AOTScorer` loads it back (``torch.export.load``) with the weights
and the config, and serves with no ``ModCRModel``.  The three attention
kernels appear in the program as the dispatcher ops of ``ops/`` (importing
this module registers them), so the loaded program launches the same CUDA
kernels on the card and runs their plain versions on the CPU.  Layout, as
the JAX package's::

    artifact/
      scorer_program.pt2      torch.export.save of the ExportedProgram
                              (generator_program.pt2 for a generator)
      params.pt               the flat state dict (torch.save; loaded with
                              weights_only=True), each tensor in its dtype
      artifact.json           kind, config, micro_batch, param_dtypes,
                              batch_keys, use_device_table, table_capacity,
                              device, executable (null)

The artifact is weight-separable: a state dict of the same keys and shapes
swapped into ``params.pt`` serves without a new export (its tensors are cast
to the recorded dtypes).  A device-table scorer exports too: the table's
tensors are program inputs, the reload rebuilds the table from the serving
box's feature source and pads it to the ``table_capacity`` the program was
traced with.

The program is exported on the device that serves, and ``artifact.json``
records it: factory ops such as ``arange`` carry their device in the graph.
Loading a CUDA artifact where there is no card raises.

The JAX package has a second load path, a serialized compiled executable
(``scorer_exec.pjrt``), which skips XLA's compile at standup.  An
``ExportedProgram``'s module runs eagerly, so there is no compile to skip,
and AOTInductor's C++ runtime cannot call the ops' Python implementations.
So ``"executable"`` is null here and there is no such file.

``save_generator_artifact`` exports the greedy fused program of a
:class:`RationaleGenerator`: the classify forward, then ``greedy_decode``
over ``max_rationale_len`` steps.  The decode loop has no host read, so the
export unrolls it; the KV cache's in-place writes stay in-place ``copy_``
nodes.  :class:`AOTGenerator` serves it without a ``RationaleModel``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Sequence

import torch
import torch.nn as nn
from torch.func import functional_call

import multimodal_context_reasoning_torch.ops  # noqa: F401  (registers the kernels' ops)
from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.data.collate import BatchSpec
from multimodal_context_reasoning_torch.data.device_table import DeviceFeatureTable
from multimodal_context_reasoning_torch.data.pmr import PMRDataset
from multimodal_context_reasoning_torch.data.schemas import RawExample
from multimodal_context_reasoning_torch.serving.generator import (
    classify_batch,
    format_generate_results,
    greedy_prompt,
)
from multimodal_context_reasoning_torch.serving.scorer import (
    build_host_batch,
    device_batch,
    format_score_results,
    pad_by_repetition,
    run_chunked,
)
from multimodal_context_reasoning_torch.train.step import model_inputs

PROGRAM_FILE = "scorer_program.pt2"
GEN_PROGRAM_FILE = "generator_program.pt2"
PARAMS_FILE = "params.pt"
META_FILE = "artifact.json"


def _module_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor the forward reads: parameters and buffers (the int8
    codes and scales are non-persistent buffers), detached."""
    out = {k: v.detach() for k, v in model.named_parameters()}
    out.update((k, v.detach()) for k, v in model.named_buffers())
    return out


class _Call(nn.Module):
    """Runs ``_fn(module, *args)`` as a module's forward, so that
    ``functional_call`` swaps the tensors of ``module`` for the call."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.m = module

    def forward(self, *args, _fn):
        return _fn(self.m, *args)


class _Program(nn.Module):
    """``forward(params, *args)`` = ``fn(model, *args)`` with the model's
    tensors replaced by ``params`` (keyed as the model names them).  The
    model is held outside the registered children, so the export lifts no
    weight of its own."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        object.__setattr__(self, "call", _Call(model))
        object.__setattr__(self, "fn", fn)

    def forward(self, params, *args):
        return functional_call(self.call, {"m." + k: v for k, v in params.items()}, args,
                               kwargs={"_fn": self.fn}, strict=True)


def _export(directory: str, program_file: str, model: nn.Module, fn, args) -> Dict:
    """Export ``fn(model, *args)`` with the model's tensors as inputs, save
    the program and the tensors; returns the tensors' dtypes."""
    os.makedirs(directory, exist_ok=True)
    params = _module_tensors(model)
    with torch.no_grad():
        exported = torch.export.export(_Program(model, fn), (params, *args))
    exported.example_inputs = None   # the program holds shapes, not weights
    torch.export.save(exported, os.path.join(directory, program_file))
    torch.save(params, os.path.join(directory, PARAMS_FILE))
    return {k: str(v.dtype).replace("torch.", "") for k, v in params.items()}


def _read_meta(directory: str, kind: str) -> Dict:
    """``artifact.json``; raises when it holds another kind."""
    with open(os.path.join(directory, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("kind", "scorer") != kind:
        raise ValueError(f"{directory} holds a {meta.get('kind')!r} artifact, "
                         f"not a {kind}")
    return meta


def _load(directory: str, program_file: str, meta: Dict):
    """(device, params, program module) of an artifact."""
    device = resolve_device(meta["device"])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dtypes = meta["param_dtypes"]
    params = torch.load(os.path.join(directory, PARAMS_FILE), map_location=device,
                        weights_only=True)
    if set(params) != set(dtypes):
        raise ValueError(f"{PARAMS_FILE} keys differ from the artifact's "
                         f"({len(params)} vs {len(dtypes)})")
    params = {k: v if str(v.dtype) == f"torch.{dtypes[k]}" else v.to(getattr(torch, dtypes[k]))
              for k, v in params.items()}
    program = torch.export.load(os.path.join(directory, program_file)).module()
    # export guards each traced ``.to()`` with an ``_assert_tensor_metadata``
    # node.  The module's input check already holds every input's dtype,
    # shape and device, which fix those of every intermediate, and the
    # asserts cost the host as much as the forward's own ops (about 400 of
    # them in a tiny scorer): they go.
    assert_meta = torch.ops.aten._assert_tensor_metadata.default
    for node in list(program.graph.nodes):
        if node.op == "call_function" and node.target is assert_meta:
            program.graph.erase_node(node)
    program.recompile()
    return device, params, program


def _scorer_forward(model, batch):
    return model(model_inputs(batch)).logits


def save_scorer_artifact(directory: str, scorer) -> None:
    """Export a warmed :class:`ModCRScorer` to ``directory``."""
    ex = RawExample(
        example_id="export", img_id=next(iter(scorer.features.keys())),
        premise="export trace .", answer_choices=["a ."] * scorer.config.num_labels,
        answer_label=0,
    )
    _, feats = pad_by_repetition([scorer.featurize(ex)], scorer.micro_batch)
    # table mode: the image leg is a row id, and the table's tensors are
    # program inputs, so a reload can feed its own feature set
    batch = device_batch(build_host_batch(feats, scorer._ds.spec, scorer.config.num_labels,
                                          table_mode=scorer.table is not None),
                         scorer.device, scorer.table)
    dtypes = _export(directory, PROGRAM_FILE, scorer.model, _scorer_forward, (batch,))
    with open(os.path.join(directory, META_FILE), "w") as f:
        json.dump({
            "kind": "scorer",
            "config": json.loads(scorer.config.to_json()),
            "micro_batch": scorer.micro_batch,
            "param_dtypes": dtypes,
            # the program's real input signature: the table's tensors too
            "batch_keys": sorted(batch.keys()),
            "executable": None,
            "use_device_table": scorer.table is not None,
            # the row count is baked into the program's input shapes
            "table_capacity": (int(scorer.table.table.shape[0])
                               if scorer.table is not None else 0),
            "device": scorer.device.type,
            "torch_version": torch.__version__,
        }, f, indent=2)


class AOTScorer:
    """The :class:`ModCRScorer` protocol (``featurize``,
    ``score_featurized``, ``micro_batch``, ``score``) from an artifact
    directory, with no model construction: a drop-in for the HTTP server
    and its batcher."""

    def __init__(self, directory: str, bert_tokenizer, roberta_tokenizer,
                 image_features: Mapping, *, warm: bool = True):
        meta = _read_meta(directory, "scorer")
        self.device, self.params, self._program = _load(directory, PROGRAM_FILE, meta)
        self.config = ModCRConfig.from_json(json.dumps(meta["config"]))
        self.micro_batch = int(meta["micro_batch"])
        self.batch_keys = list(meta["batch_keys"])
        self.features = image_features
        c = self.config
        spec = BatchSpec(text_len=c.text_len, img_len=c.img_len, roberta_len=c.roberta_len,
                         num_labels=c.num_labels,
                         img_feature_dim=c.global_encoder.img_feature_dim)
        self._ds = PMRDataset([], image_features, bert_tokenizer, roberta_tokenizer,
                              spec=spec, max_chunks=c.max_chunks)
        self.table = None
        if meta.get("use_device_table"):
            # this box's feature source, padded to the traced row capacity
            self.table = DeviceFeatureTable.for_config(
                image_features, c, capacity=int(meta["table_capacity"]), device=self.device)
        if warm:
            self.score([RawExample(
                example_id="warm", img_id=next(iter(image_features.keys())),
                premise="warm up .", answer_choices=["a ."] * c.num_labels,
                answer_label=0)])

    def featurize(self, ex: RawExample):
        if self.table is not None:
            return self._ds.featurize(ex), self.table.row_for(ex.img_id)
        return self._ds.featurize(ex), self._ds.get_image(ex)

    def score_featurized(self, feats: Sequence, example_ids: Sequence[str]) -> List[Dict]:
        if not feats:
            return []
        real, feats = pad_by_repetition(feats, self.micro_batch)
        batch = device_batch(build_host_batch(feats, self._ds.spec, self.config.num_labels,
                                              table_mode=self.table is not None),
                             self.device, self.table)
        with torch.inference_mode():
            logits = self._program(self.params, batch)
        return format_score_results(logits.float().cpu().numpy()[:real], example_ids)

    def score(self, examples: Sequence[RawExample]) -> List[Dict]:
        return run_chunked(self, examples)


# ---------------------------------------------------------------------------
# Rationale generator artifacts (the /generate endpoint)
# ---------------------------------------------------------------------------


def _generator_forward(max_len: int, eos_id: int, pad_id: int):
    """The fused greedy program: the classify forward, then the greedy
    decode over its decoder memory."""
    from multimodal_context_reasoning_torch.generation.decode import greedy_decode

    def fn(model, batch, prompt, prompt_len):
        out = model(batch)
        tokens, lengths = greedy_decode(
            model.dec, prompt, prompt_len, memory=out.decoder_memory.float(),
            memory_mask=out.decoder_memory_mask, max_len=max_len, eos_id=eos_id,
            pad_id=pad_id)
        return out.mp_probs, tokens, lengths
    return fn


def save_generator_artifact(directory: str, generator) -> None:
    """Export a warmed greedy :class:`RationaleGenerator` to ``directory``.

    Only the fused greedy program exports: sampling takes a per-call
    generator.  The rationale marker ids are recorded, since the EOS id is
    baked into the program: the reload checks that its tokenizer maps
    ``<|b_rtnl|>`` / ``<|e_rtnl|>`` to the same ids."""
    if generator.mode != "greedy":
        raise NotImplementedError(
            "only the fused greedy program exports; sampling takes a "
            "per-call rng (serve it live)"
        )
    ex = RawExample(
        example_id="export", img_id=next(iter(generator.features.keys())),
        premise="export trace .", answer_choices=["a ."] * generator.num_labels,
        answer_label=0,
    )
    _, feats = pad_by_repetition([generator.featurize(ex)], generator.micro_batch)
    batch = classify_batch(feats, generator.spec, generator.device)
    prompt, prompt_len = greedy_prompt(generator.b_rtnl, generator.micro_batch,
                                       generator.device)
    fn = _generator_forward(generator.max_rationale_len, generator.e_rtnl,
                            generator.gpt2_config.pad_token_id)
    dtypes = _export(directory, GEN_PROGRAM_FILE, generator.model, fn,
                     (batch, prompt, prompt_len))
    with open(os.path.join(directory, META_FILE), "w") as f:
        json.dump({
            "kind": "generator",
            "spec": dataclasses.asdict(generator.spec),
            "num_labels": generator.num_labels,
            "max_chunks": generator._ds.max_chunks,
            "micro_batch": generator.micro_batch,
            "max_rationale_len": generator.max_rationale_len,
            "b_rtnl": generator.b_rtnl,
            "e_rtnl": generator.e_rtnl,
            "gpt_vocab_size": generator.gpt2_config.vocab_size,
            "bert_vocab_size": generator.encoder_config.vocab_size,
            "param_dtypes": dtypes,
            "batch_keys": sorted(batch.keys()),
            "executable": None,
            "device": generator.device.type,
            "torch_version": torch.__version__,
        }, f, indent=2)


class AOTGenerator:
    """The greedy :class:`RationaleGenerator` protocol from an artifact
    directory, with no model construction: a drop-in for the server's
    /generate batcher."""

    def __init__(self, directory: str, bert_tokenizer, gpt_tokenizer,
                 image_features: Mapping, *, warm: bool = True):
        from multimodal_context_reasoning_torch.data.rationale import B_RTNL, E_RTNL
        from multimodal_context_reasoning_torch.data.vcr import VCRDataset

        meta = _read_meta(directory, "generator")
        self.micro_batch = int(meta["micro_batch"])
        self.num_labels = int(meta["num_labels"])
        self.features = image_features
        self.gpt_tokenizer = gpt_tokenizer
        self.b_rtnl, self.e_rtnl = int(meta["b_rtnl"]), int(meta["e_rtnl"])
        # the EOS id is baked into the program: the reload's tokenizer must
        # map the markers to the same ids
        b_id, e_id = gpt_tokenizer.convert_tokens_to_ids([B_RTNL, E_RTNL])
        if (int(b_id), int(e_id)) != (self.b_rtnl, self.e_rtnl):
            raise ValueError(
                f"tokenizer maps rationale markers to ({int(b_id)}, "
                f"{int(e_id)}) but the artifact was exported with "
                f"({self.b_rtnl}, {self.e_rtnl})"
            )
        self.device, self.params, self._program = _load(directory, GEN_PROGRAM_FILE, meta)
        self.spec = BatchSpec(**meta["spec"])
        self._ds = VCRDataset([], image_features, bert_tokenizer, gpt_tokenizer,
                              spec=self.spec, max_chunks=int(meta["max_chunks"]))
        if warm:
            self.generate([RawExample(
                example_id="warm", img_id=next(iter(image_features.keys())),
                premise="warm up .", answer_choices=["a ."] * self.num_labels,
                answer_label=0)])

    def featurize(self, ex: RawExample):
        return self._ds.featurize(ex), self._ds.get_image(ex)

    def score_featurized(self, feats: Sequence, example_ids: Sequence[str]) -> List[Dict]:
        if not feats:
            return []
        real, feats = pad_by_repetition(feats, self.micro_batch)
        batch = classify_batch(feats, self.spec, self.device)
        prompt, prompt_len = greedy_prompt(self.b_rtnl, self.micro_batch, self.device)
        with torch.inference_mode():
            probs, tokens, lengths = self._program(self.params, batch, prompt, prompt_len)
        return format_generate_results(
            probs.cpu().numpy(), tokens.cpu().numpy(), lengths.cpu().numpy(), real,
            example_ids, e_rtnl=self.e_rtnl, gpt_tokenizer=self.gpt_tokenizer)

    def generate(self, examples: Sequence[RawExample]) -> List[Dict]:
        return run_chunked(self, examples)
