"""Online PMR scorer (port of the JAX package's ``serving/scorer.py``
without its mesh and device-table options).

Requests are featurized on the host (numpy), padded by repetition to a
fixed micro-batch of examples, collated to ``micro_batch × num_labels``
candidate rows, and scored by one deterministic ``ModCRModel`` forward under
``torch.inference_mode()``.  The scorer runs on the GPU unless the caller
passes ``device="cpu"``; asking for CUDA where there is none raises.  A CUDA
device is held with its index (the current device at construction), so a
thread other than the constructing one, such as the batcher's dispatcher
(serving/batcher.py), scores on the same card.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.data.collate import BatchSpec, collate_candidates
from multimodal_context_reasoning_torch.data.pmr import PMRDataset
from multimodal_context_reasoning_torch.data.schemas import ImageFeatures, RawExample
from multimodal_context_reasoning_torch.models.modcr import ModCRModel


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


def run_chunked(endpoint, examples: Sequence[RawExample]) -> List[Dict]:
    """Score any number of examples through an endpoint with the
    ``featurize`` / ``score_featurized`` / ``micro_batch`` protocol,
    chunking to its micro-batch."""
    out: List[Dict] = []
    mb = endpoint.micro_batch
    for start in range(0, len(examples), mb):
        chunk = list(examples[start:start + mb])
        out.extend(endpoint.score_featurized(
            [endpoint.featurize(ex) for ex in chunk],
            [ex.example_id for ex in chunk],
        ))
    return out


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
    ):
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if isinstance(weights, nn.Module):
            model = weights.to(self.device)
        else:
            model = ModCRModel(config, device=self.device)
            model.load_state_dict(weights, strict=True)
        self.model = cast_to_compute_dtypes(model).eval()
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
        """Host-side featurization of one example (numpy only)."""
        return self._ds.featurize(ex), self._ds.get_image(ex)

    def device_batch(self, feats: Sequence) -> Dict[str, torch.Tensor]:
        """Collate a full micro-batch of :meth:`featurize` outputs and move
        it to the scorer's device (labels dropped)."""
        batch = collate_candidates([f[0] for f in feats], [f[1] for f in feats],
                                   self._ds.spec)
        batch.pop("label")
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def score_featurized(self, feats: Sequence, example_ids: Sequence[str]) -> List[Dict]:
        """One forward over up to micro_batch featurized examples."""
        if not feats:
            return []
        real, feats = pad_by_repetition(feats, self.micro_batch)
        with torch.inference_mode():
            logits = self.model(self.device_batch(feats)).logits
        return format_score_results(logits.float().cpu().numpy()[:real], example_ids)

    def score(self, examples: Sequence[RawExample]) -> List[Dict]:
        """Score any number of examples, chunked to the micro-batch (the
        last chunk padded by repetition)."""
        return run_chunked(self, examples)
