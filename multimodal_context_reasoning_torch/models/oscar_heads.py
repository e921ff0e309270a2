"""Oscar-lineage task heads over the image-text encoder (port of the JAX
package's ``models/oscar_heads.py``; reference modeling/modeling_bert.py).

- :class:`SequenceClassificationHead` (``ImageBertForSequenceClassification``,
  :424-491): pooled CLS -> dropout -> classifier; CE, or MSE when
  ``num_labels == 1``;
- :class:`MultipleChoiceHead` (``ImageBertForMultipleChoice``, :492-573):
  per-choice pooled CLS -> Linear(1) -> reshape (-1, num_choices) -> CE;
- :class:`CaptioningLoss` (``BertCaptioningLoss``, :715-743): label
  smoothing, and a drop-worst fraction that keeps the smallest losses;
- :class:`MaskedCaptionHead` (``BertForImageCaptioning``'s scorer,
  :744-1054): dense + activation + LayerNorm, then a decoder tied to the
  word embeddings passed in, plus ``decoder_bias``;
- :class:`PretrainingHeads` (``BertImgForPreTraining``, :2045-2140): that
  MLM head and the image-text-matching binary head.

The JAX heads' Dense and LayerNorm take no ``dtype``, so over a bf16 encoder
they compute in fp32 (flax promotes to the fp32 parameters); these do too.
The composition (encoder -> head) is the caller's.  Parameters start from
the JAX package's init distributions, drawn from ``generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_context_reasoning_torch.core.config import EncoderConfig
from multimodal_context_reasoning_torch.models.layers import ACT, LayerNorm, Linear
from multimodal_context_reasoning_torch.models.modcr import init_dense_weights_


def _init(module: nn.Module, c: EncoderConfig, generator: Optional[torch.Generator]) -> None:
    if generator is None:
        generator = torch.Generator(device=next(module.parameters()).device).manual_seed(0)
    init_dense_weights_(module, generator, c.initializer_range)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


class SequenceClassificationHead(nn.Module):
    def __init__(self, config: EncoderConfig, num_labels: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_labels = num_labels
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_labels)
        _init(self, config, generator)

    def forward(self, pooled: torch.Tensor, labels: Optional[torch.Tensor] = None):
        logits = self.classifier(self.dropout(pooled))
        loss = None
        if labels is not None:
            if self.num_labels == 1:   # regression (modeling_bert.py:478-480)
                loss = ((logits[..., 0] - labels) ** 2).mean()
            else:
                loss = _ce(logits, labels)
        return loss, logits


class MultipleChoiceHead(nn.Module):
    def __init__(self, config: EncoderConfig, num_choices: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_choices = num_choices
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, 1)
        _init(self, config, generator)

    def forward(self, pooled: torch.Tensor, labels: Optional[torch.Tensor] = None):
        """``pooled``: [B·num_choices, D] per-choice CLS vectors."""
        logits = self.classifier(self.dropout(pooled)).reshape(-1, self.num_choices)
        return (None if labels is None else _ce(logits, labels)), logits


class CaptioningLoss(nn.Module):
    """Label-smoothed CE with drop-worst (modeling_bert.py:715-743)."""

    def __init__(self, label_smoothing: float = 0.1, drop_worst_ratio: float = 0.0):
        super().__init__()
        self.label_smoothing = label_smoothing
        self.drop_worst_ratio = drop_worst_ratio

    def forward(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """``logits``: [N, V]; ``targets``: [N] int.  Returns the scalar loss."""
        eps = self.label_smoothing
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets.long()[:, None])[:, 0]
        loss = (1.0 - eps) * nll + eps * -logp.mean(dim=-1)
        if self.drop_worst_ratio > 0.0:
            keep = loss.shape[0] - int(loss.shape[0] * self.drop_worst_ratio)
            loss = torch.topk(loss, keep, largest=False).values   # the smallest losses
        return loss.mean()


class MaskedCaptionHead(nn.Module):
    """Transform + tied decoder (BertForImageCaptioning's cls head); the
    tied embedding table is passed in."""

    def __init__(self, config: EncoderConfig, vocab_size: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.act = ACT[c.hidden_act]
        self.transform = Linear(c.hidden_size, c.hidden_size)
        self.transform_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.decoder_bias = nn.Parameter(torch.zeros(vocab_size))
        _init(self, config, generator)

    def forward(self, hidden: torch.Tensor, word_embedding: torch.Tensor) -> torch.Tensor:
        x = self.transform_layer_norm(self.act(self.transform(hidden)))
        return x @ word_embedding.float().T + self.decoder_bias


class PretrainOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    mlm_logits: torch.Tensor
    itm_logits: torch.Tensor


class PretrainingHeads(nn.Module):
    """MLM + image-text-matching heads (BertImgForPreTraining,
    modeling_bert.py:2045-2140)."""

    def __init__(self, config: EncoderConfig, vocab_size: int, num_seq_relations: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.predictions = MaskedCaptionHead(config, vocab_size)
        self.seq_relationship = Linear(config.hidden_size, num_seq_relations)
        _init(self, config, generator)

    def forward(
        self,
        sequence: torch.Tensor,                      # [B, L, D]
        pooled: torch.Tensor,                        # [B, D]
        word_embedding: torch.Tensor,                # [V, D] tied table
        mlm_labels: Optional[torch.Tensor] = None,   # [B, L], -100 = ignore
        itm_labels: Optional[torch.Tensor] = None,   # [B]
    ) -> PretrainOutput:
        mlm_logits = self.predictions(sequence, word_embedding)
        itm_logits = self.seq_relationship(pooled)
        loss = None
        if mlm_labels is not None and itm_labels is not None:
            logp = F.log_softmax(mlm_logits.float(), dim=-1)
            nll = -logp.gather(-1, mlm_labels.long().clamp(min=0)[..., None])[..., 0]
            keep = (mlm_labels >= 0).float()
            mlm_loss = (nll * keep).sum() / keep.sum().clamp(min=1.0)
            loss = mlm_loss + _ce(itm_logits, itm_labels)
        return PretrainOutput(loss, mlm_logits, itm_logits)
