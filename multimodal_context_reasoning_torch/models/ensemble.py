"""Ablation ensemble family (port of the JAX package's ``models/ensemble.py``).

The reference keeps fourteen near-duplicate ensembles
(modeling/modeling_ensemble.py:45-869).  They share one computation — score
each candidate from a CALeC view and a text-LM view, combine, cross-entropy
over 4 — and differ in the combine rule and the loss, which are options
here:

- ``fusion``:
    * ``concat``      — Linear(Dc+Dr → 1) on the concatenated CLS vectors
                        (dual_ensemble_model :45-80)
    * ``add``         — one Linear(·→1) head per view, logits summed
                        (dual_ensemble_model_add :82-122)
    * ``logit_add``   — the plain sum of per-view logits
                        (ensemble_model_t2 :603-661)
    * ``learned_add`` — a learnable scalar gate per view on its logits
                        (ensemble_model_t3 :663-726)
- ``loss``:
    * ``ce``          — cross-entropy over the 4-way logits
    * ``hinge``       — pairwise margin loss on the raw logits
                        (dual_ensemble_model_pairwise :124-181)
    * ``ce+hinge``    — both, the hinge on the softmaxed logits
                        (dual_ensemble_model_doubleloss :183-247, margin 0.5)

:class:`VoteEnsemble` is ``model_vote`` (:859-869).  The CLIP-gated variants
live in models/clip_ensemble.py.  :class:`DualEnsembleModel` runs the
towers; with ``text_view="gpt2"`` it is ``dual_ensemble_model_gpt``
(:249-287).

Submodules carry the JAX tree's names (``global_enc``, ``seq_enc``,
``fusion``, ``roberta`` | ``gpt``, ``ensemble.{classifier,
classifier_<view>, view_gates}``), so interop/from_jax.py maps each tower
by a rename.  The heads compute in fp32, as flax's ``Dense`` promotes a
bf16 input over fp32 parameters.  Dropout follows ``self.training``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import GPT2Config, ModCRConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.models.encoders import (
    ChunkAlignEncoder,
    GlobalImageEncoder,
)
from multimodal_context_reasoning_torch.models.fusion import ChunkAlignFusion
from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder
from multimodal_context_reasoning_torch.models.layers import Linear
from multimodal_context_reasoning_torch.models.modcr import (
    init_dense_weights_,
    soft_cross_entropy,
)
from multimodal_context_reasoning_torch.models.roberta import PrefixRoberta


class EnsembleOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    logits: torch.Tensor          # [Q, num_labels]


def pairwise_hinge_loss(
    logits: torch.Tensor,      # [Q, K]
    targets: torch.Tensor,     # [Q, K] multi-hot
    margin: float = 0.5,
    *,
    use_probs: bool = False,
) -> torch.Tensor:
    """relu(margin + s_i − s_gold) summed over all (i, gold) pairs.

    ``use_probs=False`` applies the margin to the raw logits (the pure-hinge
    ablation, modeling_ensemble.py:161-176); ``use_probs=True`` softmaxes
    first (the doubleloss ablation, :218-238)."""
    scores = logits.float()
    if use_probs:
        scores = torch.softmax(scores, dim=-1)
    targets = targets.float()
    gold = (scores * targets).sum(-1, keepdim=True) / torch.clamp(
        targets.sum(-1, keepdim=True), min=1.0)
    return torch.relu(margin + scores - gold).sum()


class CandidateEnsemble(nn.Module):
    """Combine per-candidate view vectors (or logits) into 4-way logits.

    ``views`` names the views in the order the forward receives them, with
    each view's width (used by ``concat`` and ``add``)."""

    def __init__(self, views: Dict[str, int], num_labels: int = 4,
                 fusion: str = "concat", loss: str = "ce", margin: float = 0.5):
        super().__init__()
        self.num_labels = num_labels
        self.fusion = fusion
        self.loss = loss
        self.margin = margin
        if fusion == "concat":
            self.classifier = Linear(sum(views.values()), 1)
        elif fusion == "add":
            for name, width in views.items():
                self.add_module(f"classifier_{name}", Linear(width, 1))
        elif fusion == "learned_add":
            self.view_gates = nn.Parameter(torch.ones(len(views)))
        elif fusion != "logit_add":
            raise ValueError(f"unknown fusion {fusion}")

    def forward(
        self,
        views: Dict[str, torch.Tensor],
        label: Optional[torch.Tensor] = None,   # [Q*K] multi-hot targets
    ) -> EnsembleOutput:
        """``views``: for concat/add {name: [Q*K, D_name] CLS vectors}; for
        logit_add/learned_add {name: [Q*K, 1] or [Q, K] logits}."""
        K = self.num_labels
        if self.fusion == "concat":
            x = torch.cat([v.float() for v in views.values()], dim=-1)
            logits = self.classifier(x).view(-1, K)
        elif self.fusion == "add":
            logits = sum(getattr(self, f"classifier_{k}")(v)
                         for k, v in views.items()).view(-1, K)
        elif self.fusion == "logit_add":
            logits = sum(v.reshape(-1, K) for v in views.values())
        else:
            logits = sum(g * v.reshape(-1, K)
                         for g, v in zip(self.view_gates, views.values()))

        loss = None
        if label is not None:
            targets = label.reshape(-1, K)
            loss = torch.zeros((), device=logits.device)
            if "ce" in self.loss:
                loss = loss + soft_cross_entropy(logits, targets)
            if "hinge" in self.loss:
                # pure 'hinge' = pairwise ablation (raw logits);
                # 'ce+hinge' = doubleloss ablation (softmaxed probs)
                loss = loss + pairwise_hinge_loss(logits, targets, self.margin,
                                                  use_probs="ce" in self.loss)
        return EnsembleOutput(loss=loss, logits=logits)


class VoteEnsemble(nn.Module):
    """model_vote (modeling_ensemble.py:859-869): a learned vote over the
    choice logits of ``num_models`` upstream models."""

    def __init__(self, num_models: int, num_labels: int = 4):
        super().__init__()
        self.num_labels = num_labels
        self.vote = Linear(num_models, 1)

    def forward(
        self,
        model_logits: torch.Tensor,            # [N_models, Q, K]
        label: Optional[torch.Tensor] = None,  # [Q, K] multi-hot
    ) -> EnsembleOutput:
        N, Q, K = model_logits.shape
        logits = self.vote(model_logits.permute(1, 2, 0))[..., 0]   # [Q, K]
        loss = None
        if label is not None:
            loss = soft_cross_entropy(logits, label.reshape(Q, K))
        return EnsembleOutput(loss=loss, logits=logits)


class DualEnsembleModel(nn.Module):
    """The runnable CALeC + text-LM ensemble (dual_ensemble_model family,
    modeling_ensemble.py:45-287).

    Unlike :class:`~multimodal_context_reasoning_torch.models.modcr.
    ModCRModel`, the reasoner sees no prefix: the two views meet only at
    the CLS level, in :class:`CandidateEnsemble`.  The batch is the same
    candidate-expanded dict.  The forward returns ``(EnsembleOutput,
    align_loss)``.

    - ``text_view="roberta"``: RoBERTa-large over ``r_input_ids`` with no
      prefix, so on the card its 24 layers take the stage-mask kernel in the
      "full" stage at Lq = Lk = ``roberta_len`` (the dense-bias kernels under
      ``remat``).  The global encoder's 12 layers and the ChunkAlign
      encoder's chunk and full layers take the stage-mask kernel too; its
      cross layers return probabilities for the alignment loss and take the
      plain attention.
    - ``text_view="gpt2"``: a GPT-2 tower (``gpt2_config``, by default GPT-2
      small at the encoders' width with no cross-attention) over the
      gpt-framed stream (``VCRDataset(lm_style="gpt")``).  The reference
      also feeds token types to its GPT-2 (:268-269), but that dataset emits
      all-zero segments, a constant shift; this GPT-2 takes none, as the
      JAX one.  ``gpt_pool="first"`` takes position 0 as the reference does
      (:273): under causal attention it sees only ``<bos>``, so that view is
      the same for the 4 candidates; ``"last_real"`` takes the last non-pad
      position.

    Parameters are created on ``device`` (the GPU unless the caller passes
    ``device="cpu"``) and drawn from ``generator`` with the JAX package's
    init distributions."""

    def __init__(self, config: ModCRConfig, fusion: str = "concat", loss: str = "ce",
                 text_view: str = "roberta", gpt_pool: str = "first",
                 gpt2_config: Optional[GPT2Config] = None, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        if text_view not in ("roberta", "gpt2"):
            raise ValueError(f"unknown text_view {text_view}")
        if gpt_pool not in ("first", "last_real"):
            raise ValueError(f"unknown gpt_pool {gpt_pool}")
        self.config = c
        self.text_view = text_view
        self.gpt_pool = gpt_pool
        with torch.device(resolve_device(device)):
            self.global_enc = GlobalImageEncoder(c.global_encoder)
            self.seq_enc = ChunkAlignEncoder(c.seq_encoder, c.chunkalign)
            self.fusion = ChunkAlignFusion(c.global_encoder, c.chunkalign)
            if text_view == "gpt2":
                gcfg = gpt2_config or GPT2Config(n_embd=c.global_encoder.hidden_size,
                                                 add_cross_attention=False)
                self.gpt = GPT2Decoder(gcfg)
                text_width = gcfg.n_embd
            else:
                self.roberta = PrefixRoberta(c.roberta)
                text_width = c.roberta.hidden_size
            self.ensemble = CandidateEnsemble(
                {"calec": c.global_encoder.hidden_size, text_view: text_width},
                num_labels=c.num_labels, fusion=fusion, loss=loss)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:
            generator = torch.Generator(device=next(self.parameters()).device)
            generator.manual_seed(0)
        init_dense_weights_(self, generator, self.config.global_encoder.initializer_range)
        if self.text_view == "gpt2":
            self.gpt.init_weights(generator)

    def text_cls(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The text view's per-candidate vector [Q*K, D]."""
        ids, mask = batch["r_input_ids"], batch["r_attention_mask"]
        if self.text_view == "roberta":
            return self.roberta(ids, mask, token_type_ids=batch.get("r_token_type_ids")).pooled
        h, _ = self.gpt.final_hidden(ids, attn_mask=mask)
        if self.gpt_pool == "first":
            return h[:, 0]                                 # ensemble:273 verbatim
        last = torch.clamp(mask.long().sum(-1) - 1, min=0)
        return h[torch.arange(h.shape[0], device=h.device), last]

    def forward(self, batch: Dict[str, torch.Tensor]):
        c = self.config
        input_ids = batch["input_ids"]
        text_mask = batch["text_mask"]
        img_feat = batch["img_feat"]
        img_mask = batch["img_mask"]
        token_type_ids = batch.get("token_type_ids")
        T = input_ids.shape[1]

        g = self.global_enc(input_ids, img_feat, torch.cat([text_mask, img_mask], dim=-1),
                            token_type_ids)
        s = self.seq_enc(input_ids, img_feat, text_mask, img_mask, batch.get("chunk_mask"),
                         batch["gather_index"], c.max_chunks, token_type_ids)
        fused = self.fusion(g.sequence, g.pooled, s.sequence, s.pooled, s.chunk_hidden,
                            s.attn_probs, text_mask, T, align_pos=batch.get("align_pos"),
                            total_label=batch.get("total_label"))
        out = self.ensemble({"calec": fused.cls_ensem, self.text_view: self.text_cls(batch)},
                            batch.get("label"))
        return out, fused.align_loss

