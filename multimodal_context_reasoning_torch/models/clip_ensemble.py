"""CLIP-gated ensemble ablations (port of the JAX package's
``models/clip_ensemble.py``).

The reference loads a frozen CLIP ViT-B/16 at import (run_PMR_ModCR.py:450)
and only its ablation classes consume it.  A frozen tower's outputs are
features, so these heads take the ``[Q, 512]`` image and ``[Q, K, 512]``
candidate-text embeddings as inputs, precomputed by cli/precompute_clip.py
or computed in the forward by :class:`ClipEndToEnd`.

Rebuilt variants (modeling_ensemble.py):

- :func:`clip_similarity` + :func:`clip_top2_gate` — the cosine similarity
  and the top-2 gate of ``ensemble_model_t1`` (:568-587): the two
  best-matching candidates carry the mean of the top-2 scores, every other
  position 1.0;
- :class:`ClipGatedEnsemble` — ``ensemble_model_t1`` (:543-602): the gate
  scales the concatenated [CALeC ‖ RoBERTa] CLS feature before a
  ``Linear(1792, 1)`` scorer;
- :class:`ClipSimilarityFusion` — ``dual_ensemble_model_clip`` (:290-352):
  ``(logits + cosine_similarity) / 2``;
- :class:`ClipOnlyModel` — ``clip_model`` (:793-822, raw concat through
  ``easy_fusion``) and ``clip_model_r`` (:824-858, normalized elementwise
  product ×1000) behind ``variant=``, each with the reference's cast of the
  features to fp32 (:810-811, :846-847);
- :class:`ClipEndToEnd` — ``clip_model`` / ``clip_model_r`` from pixels.

The heads compute in fp32, as flax's ``Dense`` promotes its input over fp32
parameters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import CLIPConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.generation.beam import stable_top_k
from multimodal_context_reasoning_torch.models.clip import CLIP
from multimodal_context_reasoning_torch.models.layers import Linear
from multimodal_context_reasoning_torch.models.modcr import (
    init_dense_weights_,
    soft_cross_entropy,
)


class ClipEnsembleOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    logits: torch.Tensor              # [Q, K]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def clip_similarity(image_emb: torch.Tensor,       # [Q, D_clip]
                    text_emb: torch.Tensor,        # [Q, K, D_clip]
                    ) -> torch.Tensor:
    """L2-normalized cosine similarity [Q, K] (ensemble:568-573)."""
    return torch.einsum("qkd,qd->qk", _unit(text_emb), _unit(image_emb))


def clip_top2_gate(similarity: torch.Tensor) -> torch.Tensor:
    """ensemble_model_t1's gate (:576-587): the top-2 candidates' positions
    carry mean(top-2 scores), the rest 1.0.  The top 2 are ``lax.top_k``'s:
    a tie goes to the lower index (``torch.topk`` promises no order)."""
    _, position = stable_top_k(similarity.float(), 2)         # [Q, 2]
    mean2 = similarity.gather(-1, position).mean(-1, keepdim=True)
    onehot = torch.zeros_like(similarity).scatter_(-1, position, 1.0)
    return onehot * mean2 + (1.0 - onehot)


class ClipGatedEnsemble(nn.Module):
    """ensemble_model_t1: gate × concat(CALeC CLS, RoBERTa pooled) →
    Linear(feature_dim, 1) → [Q, K] logits + CE."""

    def __init__(self, feature_dim: int = 1792, num_labels: int = 4):
        super().__init__()
        self.num_labels = num_labels
        self.classifier = Linear(feature_dim, 1)

    def forward(
        self,
        calec_cls: torch.Tensor,       # [Q*K, D_calec]
        roberta_pooled: torch.Tensor,  # [Q*K, D_roberta]
        image_emb: torch.Tensor,       # [Q, D_clip]
        text_emb: torch.Tensor,        # [Q, K, D_clip]
        label: Optional[torch.Tensor] = None,   # [Q*K] multi-hot
    ) -> ClipEnsembleOutput:
        K = self.num_labels
        gate = clip_top2_gate(clip_similarity(image_emb, text_emb))
        feat = torch.cat([calec_cls, roberta_pooled], dim=-1)
        feat = gate.reshape(-1, 1) * feat                      # :589-591
        logits = self.classifier(feat).view(-1, K)
        loss = None
        if label is not None:
            loss = soft_cross_entropy(logits, label.reshape(-1, K))
        return ClipEnsembleOutput(loss=loss, logits=logits)


class ClipSimilarityFusion(nn.Module):
    """dual_ensemble_model_clip (:290-352): the upstream model's choice
    logits averaged with the CLIP cosine similarity."""

    def forward(
        self,
        model_logits: torch.Tensor,    # [Q, K]
        image_emb: torch.Tensor,       # [Q, D_clip]
        text_emb: torch.Tensor,        # [Q, K, D_clip]
        label: Optional[torch.Tensor] = None,
    ) -> ClipEnsembleOutput:
        scores = (model_logits + clip_similarity(image_emb, text_emb)) / 2.0   # :335
        loss = None
        if label is not None:
            loss = soft_cross_entropy(scores, label.reshape(scores.shape))
        return ClipEnsembleOutput(loss=loss, logits=scores)


class ClipOnlyModel(nn.Module):
    """clip_model / clip_model_r: score candidates from CLIP embeddings
    alone.

    - ``variant="fusion"`` (clip_model, :793-822): concat the raw image and
      text embeddings → ``easy_fusion`` Linear(2·D→D) → Linear(D, 1);
    - ``variant="product"`` (clip_model_r, :824-858): normalized
      elementwise product scaled ×1000 → Linear(D, 1).
    """

    def __init__(self, num_labels: int = 4, variant: str = "fusion", clip_dim: int = 512):
        super().__init__()
        if variant not in ("fusion", "product"):
            raise ValueError(f"unknown variant {variant}")
        self.num_labels = num_labels
        self.variant = variant
        if variant == "fusion":
            self.easy_fusion = Linear(2 * clip_dim, clip_dim)
        self.classifier = Linear(clip_dim, 1)

    def forward(
        self,
        image_emb: torch.Tensor,       # [Q, D_clip]
        text_emb: torch.Tensor,        # [Q, K, D_clip]
        label: Optional[torch.Tensor] = None,
    ) -> ClipEnsembleOutput:
        Q, K = image_emb.shape[0], self.num_labels
        if self.variant == "fusion":
            img = image_emb[:, None].expand(text_emb.shape)
            # the reference casts the (fp16) fused feature to fp32 (:810-811)
            feat = self.easy_fusion(torch.cat([img, text_emb], dim=-1).float())
        else:
            feat = (_unit(image_emb)[:, None] * _unit(text_emb) * 1000.0).float()  # :843-847
        logits = self.classifier(feat)[..., 0]                 # [Q, K]
        loss = None
        if label is not None:
            loss = soft_cross_entropy(logits, label.reshape(Q, K))
        return ClipEnsembleOutput(loss=loss, logits=logits)


class ClipEndToEnd(nn.Module):
    """``clip_model`` / ``clip_model_r`` from pixels, the reference's own
    forward (modeling_ensemble.py:793-858): the CLIP towers on the image and
    the K candidate texts, then :class:`ClipOnlyModel`.

    Inputs: ``pixels`` [Q, S, S, 3] (data/clip_preprocess.py), ``text_ids``
    [Q·K, T] CLIP ids (data/clip_tokenizer.py), as the reference's
    ``text.squeeze(1)`` flattens its [Q, 1, 77] rows (:805).  Parameters are
    created on ``device`` (the GPU unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, config: CLIPConfig, num_labels: int = 4, variant: str = "fusion", *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_labels = num_labels
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        self.clip = CLIP(config, device=dev, generator=generator)
        with torch.device(dev):
            self.head = ClipOnlyModel(num_labels, variant, config.embed_dim)
        init_dense_weights_(self.head, generator, 0.02)

    def forward(
        self,
        pixels: torch.Tensor,          # [Q, S, S, 3]
        text_ids: torch.Tensor,        # [Q*K, T]
        label: Optional[torch.Tensor] = None,
    ) -> ClipEnsembleOutput:
        image_emb = self.clip.encode_image(pixels)                         # [Q, E]
        text_emb = self.clip.encode_text(text_ids).view(pixels.shape[0], self.num_labels, -1)
        return self.head(image_emb, text_emb, label)
