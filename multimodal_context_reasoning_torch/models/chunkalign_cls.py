"""Stage-1 ChunkAlign pretrain classifier (port of the JAX package's
``models/chunkalign_cls.py``; reference ``ChunkAlign_CLS_enc4_align``,
modeling_vcr_chunkalign_v10.py:1016-1165).

The regime that produces the reference's ChunkAlign pretrain checkpoint,
whose ``seq_enc.`` weights seed the production composite:

- both encoders are trainable;
- the fused CLS comes from ``cls_ensemble: Linear(2D, D)`` over the two
  pooled vectors;
- three single-head :class:`~.rationale.ClsReasonLayer` layers reason over
  the ``[global ‖ seq ‖ chunk_hidden]`` memory;
- ``classifier: Linear(D, 2)`` per candidate row with the binary CE, and
  :func:`~.rationale.binary_to_mp` for the 4-way decision;
- the attention-alignment CE over the last three cross-modal layers'
  probabilities (``fusion.alignment_loss_from_probs``).

``loss = cls_loss + align_weight · align_loss``.  The classifier pass is the
rationale family's (``rationale.classify_candidates``), here with the
ChunkAlign encoder's cross layers returning their probabilities, so those
three layers take the plain attention and every other encoder layer the
stage-mask kernel (21 launches a forward at full depth, and as many
backward launches a training step).  The keys are the reference's:
``global_enc.*``, ``seq_enc.*`` (with ``edge_dense``), ``cls_ensemble``,
``cls_layer.N.*`` and ``classifier``; interop/export.py writes them in the
JAX export's layout.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import ChunkAlignConfig, EncoderConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.models.encoders import (
    ChunkAlignEncoder,
    GlobalImageEncoder,
)
from multimodal_context_reasoning_torch.models.fusion import alignment_loss_from_probs
from multimodal_context_reasoning_torch.models.layers import Linear
from multimodal_context_reasoning_torch.models.modcr import init_dense_weights_
from multimodal_context_reasoning_torch.models.rationale import (
    ClsReasonLayer,
    classify_candidates,
)


class ChunkAlignClassifierOutput(NamedTuple):
    loss: torch.Tensor           # cls_loss + align_weight · align_loss
    cls_loss: torch.Tensor       # scalar binary CE (fp32)
    align_loss: torch.Tensor     # scalar alignment CE (fp32)
    logits: torch.Tensor         # [Q, num_labels] P(true) per candidate (binary_to_mp):
                                 # probabilities, named for train/step.py's metrics
    binary_logits: torch.Tensor  # [B, 2] per candidate row


class ChunkAlignClassifier(nn.Module):
    def __init__(
        self,
        config: EncoderConfig,
        schedule: ChunkAlignConfig,
        *,
        num_labels: int = 4,
        cls_layer_num: int = 3,
        max_chunks: int = 40,
        align_weight: float = 1.0,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        c = config
        self.config = c
        self.num_labels = num_labels
        self.max_chunks = max_chunks
        self.align_weight = align_weight
        with torch.device(resolve_device(device)):
            self.global_enc = GlobalImageEncoder(c)
            self.seq_enc = ChunkAlignEncoder(c, schedule)
            self.cls_ensemble = Linear(2 * c.hidden_size, c.hidden_size, c.torch_dtype)
            self.cls_layer = nn.ModuleList(ClsReasonLayer(c) for _ in range(cls_layer_num))
            self.classifier = Linear(c.hidden_size, 2, c.torch_dtype)
        if generator is None:
            generator = torch.Generator(device=self.classifier.weight.device).manual_seed(0)
        init_dense_weights_(self, generator, c.initializer_range)

    def forward(self, batch: Dict[str, torch.Tensor]) -> ChunkAlignClassifierOutput:
        p = classify_candidates(self, batch, output_attentions=True)
        align_loss, _ = alignment_loss_from_probs(
            p.s.attn_probs, batch["input_ids"].shape[1], batch.get("align_pos"),
            batch.get("total_label"))
        return ChunkAlignClassifierOutput(
            loss=p.cls_loss + self.align_weight * align_loss, cls_loss=p.cls_loss,
            align_loss=align_loss, logits=p.mp_probs, binary_logits=p.logits)
