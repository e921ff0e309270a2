"""Online PMR scorer (port of the JAX package's ``serving/scorer.py``).

Requests are featurized on the host (numpy), padded by repetition to a
fixed micro-batch of examples, collated to ``micro_batch × num_labels``
candidate rows, and scored by one deterministic ``ModCRModel`` forward under
``torch.inference_mode()``.  With ``use_device_table=True`` the whole
image-feature set stays on the device (data/device_table.py) and a request
ships one int32 row id per candidate row instead of its [I, F] features.
Under an int8 config (``with_quantize``) the weights are quantized once,
after the cast to the compute dtype.  The
scorer runs on the GPU unless the caller passes ``device="cpu"``; asking
for CUDA where there is none raises.  A CUDA
device is held with its index (the current device at construction), so a
thread other than the constructing one, such as the batcher's dispatcher
(serving/batcher.py), scores on the same card.

``mesh`` (parallel/mesh.py) scores in SPMD style: every rank calls
:meth:`ModCRScorer.score` with the same examples, forwards its data index's
block of each micro-batch through its shard of the model (the model axis
splits heads and FFN neurons, parallel/partition.py), and returns the
whole result, the blocks gathered over the data axis.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.data.collate import BatchSpec, collate_candidates
from multimodal_context_reasoning_torch.data.device_table import DeviceFeatureTable
from multimodal_context_reasoning_torch.data.pmr import PMRDataset
from multimodal_context_reasoning_torch.data.schemas import ImageFeatures, RawExample
from multimodal_context_reasoning_torch.models.layers import freeze_int8
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.parallel.comm import gather_rows
from multimodal_context_reasoning_torch.parallel.mesh import axis_group, axis_index, axis_size
from multimodal_context_reasoning_torch.parallel.partition import local_rows, shard_module_
from multimodal_context_reasoning_torch.train.step import model_inputs
from multimodal_context_reasoning_torch.utils.profiling import span


def build_host_batch(feats: Sequence, spec: BatchSpec, num_labels: int,
                     *, table_mode: bool) -> Dict[str, np.ndarray]:
    """The collated numpy batch (label dropped) of a padded micro-batch of
    ``featurize`` outputs.  In table mode each output's image leg is its
    table row, and the batch carries ``img_row`` [B·K] int32 in place of
    ``img_feat`` / ``img_mask``.  The live scorer, the AOT scorer and the
    artifact's export share it, so their batch layouts cannot drift."""
    if table_mode:
        batch = collate_candidates([f[0] for f in feats], None, spec)
        batch["img_row"] = np.repeat(np.asarray([f[1] for f in feats], np.int32),
                                     num_labels)
    else:
        batch = collate_candidates([f[0] for f in feats], [f[1] for f in feats], spec)
    batch.pop("label", None)
    return batch


def device_batch(batch: Dict[str, np.ndarray], device: torch.device,
                 table: Optional[DeviceFeatureTable] = None) -> Dict[str, torch.Tensor]:
    """A host batch copied to ``device``, with the table's resident tensors
    added in table mode (the same tensors every call: nothing re-copies)."""
    with span("data.to_device"):
        out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if table is not None:
        out["feat_table"] = table.table
        out["feat_mask_table"] = table.mask
    return out


def pad_by_repetition(feats: Sequence, micro_batch: int):
    """Validate and right-pad a featurized chunk to the micro-batch by
    repeating its last entry; returns ``(real count, padded list)``."""
    real = len(feats)
    if real > micro_batch:
        raise ValueError(f"{real} examples > micro_batch={micro_batch}")
    feats = list(feats)
    while len(feats) < micro_batch:
        feats.append(feats[-1])
    return real, feats


def format_score_results(logits: np.ndarray, example_ids: Sequence[str]) -> List[Dict]:
    """Logits [real, K] -> the /score response rows (prediction, logits,
    softmax probs)."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    return [
        {
            "example_id": eid,
            "prediction": int(np.argmax(lg)),
            "logits": [float(x) for x in lg],
            "probs": [float(x) for x in pr],
        }
        for eid, lg, pr in zip(example_ids, logits, probs)
    ]


def run_chunked(endpoint, examples: Sequence[RawExample], **kwargs) -> List[Dict]:
    """Score any number of examples through an endpoint with the
    ``featurize`` / ``score_featurized`` / ``micro_batch`` protocol,
    chunking to its micro-batch; ``kwargs`` go to every
    ``score_featurized`` call."""
    out: List[Dict] = []
    mb = endpoint.micro_batch
    for start in range(0, len(examples), mb):
        chunk = list(examples[start:start + mb])
        out.extend(endpoint.score_featurized(
            [endpoint.featurize(ex) for ex in chunk],
            [ex.example_id for ex in chunk],
            **kwargs,
        ))
    return out


def shard_for_serving(model: nn.Module, mesh, micro_batch: int, unit: str,
                      rows_per_example: Optional[int] = None) -> nn.Module:
    """``model`` sharded over ``mesh``'s model axis (unless it is already),
    after checking that the data axis divides the micro-batch's candidate
    rows (the JAX scorer's check) and its ``unit``s: each rank forwards
    whole examples."""
    n_data = axis_size(mesh, "data")
    rows = micro_batch * (rows_per_example or 1)
    if rows_per_example and rows % n_data:
        raise ValueError(
            f"the mesh's data axis ({n_data}) must divide "
            f"micro_batch×{rows_per_example}={rows} rows — "
            f"raise micro_batch or shrink the data axis"
        )
    if micro_batch % n_data:
        raise ValueError(
            f"the mesh's data axis ({n_data}) must divide "
            f"micro_batch={micro_batch} {unit} — raise "
            f"micro_batch or shrink the data axis"
        )
    if getattr(model, "tp_mesh", None) is None:
        shard_module_(model, mesh)
    return model


def cast_to_compute_dtypes(model: ModCRModel) -> ModCRModel:
    """Cast each tower's weights, once, to its config's compute dtype (the
    JAX scorer's ``params_dtype``): encoders, CALeC and the mapping
    networks to the encoders' dtype, the reasoner and its scorer to
    RoBERTa's.  LayerNorm statistics stay fp32 (PyTorch accumulates bf16
    LayerNorm in fp32)."""
    c = model.config
    model.to(c.global_encoder.torch_dtype)
    if c.use_seq_encoder:
        model.calec.seq_enc.to(c.seq_encoder.torch_dtype)
    model.roberta.to(c.roberta.torch_dtype)
    model.abst_confidence_scorer.to(c.roberta.torch_dtype)
    return model


class ModCRScorer:
    """``weights`` is a ``ModCRModel`` (moved and cast in place) or a state
    dict in the port's layout (``interop/from_jax.py``, or a reference
    checkpoint)."""

    def __init__(
        self,
        config: ModCRConfig,
        weights: Union[ModCRModel, Mapping[str, torch.Tensor]],
        bert_tokenizer,
        roberta_tokenizer,
        image_features: Mapping[str, ImageFeatures],
        *,
        micro_batch: int = 8,
        device: Union[str, torch.device] = "cuda",
        use_device_table: bool = False,
        mesh=None,
    ):
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if isinstance(weights, nn.Module):
            model = weights.to(self.device)
        else:
            model = ModCRModel(config, device=self.device)
            model.load_state_dict(weights, strict=True)
        model = cast_to_compute_dtypes(model)
        if mesh is not None:
            shard_for_serving(model, mesh, micro_batch, "examples", config.num_labels)
        # an int8 config quantizes each weight once, from the compute dtype
        # the scorer holds it in (models/layers.py::Linear)
        self.model = freeze_int8(model).eval()
        self.micro_batch = micro_batch
        spec = BatchSpec(
            text_len=config.text_len, img_len=config.img_len,
            roberta_len=config.roberta_len, num_labels=config.num_labels,
            img_feature_dim=config.global_encoder.img_feature_dim,
        )
        self._ds = PMRDataset(
            [], image_features, bert_tokenizer, roberta_tokenizer,
            spec=spec, max_chunks=config.max_chunks,
        )
        self.features = image_features
        self.table = (DeviceFeatureTable.for_config(image_features, config, device=self.device)
                      if use_device_table else None)
        if self.table is not None and mesh is not None:
            self.table.place(mesh)

    def warm_up(self) -> None:
        """Score one example of the first image (the JAX scorer's
        ``_warmup``): on the card its first forward builds and loads the
        kernels, so no request pays for that."""
        self.score([RawExample(
            example_id="warm", img_id=next(iter(self.features.keys())),
            premise="warm up .", answer_choices=["a ."] * self.config.num_labels,
            answer_label=0,
        )])

    def featurize(self, ex: RawExample):
        """Host-side featurization of one example (numpy only); in
        device-table mode the image leg is its table row."""
        if self.table is not None:
            return self._ds.featurize(ex), self.table.row_for(ex.img_id)
        return self._ds.featurize(ex), self._ds.get_image(ex)

    def device_batch(self, feats: Sequence) -> Dict[str, torch.Tensor]:
        """Collate a full micro-batch of :meth:`featurize` outputs and move
        it to the scorer's device (labels dropped; the table's tensors
        added in table mode)."""
        batch = build_host_batch(feats, self._ds.spec, self.config.num_labels,
                                 table_mode=self.table is not None)
        return device_batch(batch, self.device, self.table)

    def score_featurized(self, feats: Sequence, example_ids: Sequence[str]) -> List[Dict]:
        """One forward over up to micro_batch featurized examples."""
        if not feats:
            return []
        real, feats = pad_by_repetition(feats, self.micro_batch)
        with torch.inference_mode():
            batch = local_rows(self.device_batch(feats), self.mesh)
            logits = gather_rows(self.model(model_inputs(batch)).logits,
                                 axis_index(self.mesh, "data"), axis_group(self.mesh, "data"))
        return format_score_results(logits.float().cpu().numpy()[:real], example_ids)

    def score(self, examples: Sequence[RawExample]) -> List[Dict]:
        """Score any number of examples, chunked to the micro-batch (the
        last chunk padded by repetition)."""
        return run_chunked(self, examples)
