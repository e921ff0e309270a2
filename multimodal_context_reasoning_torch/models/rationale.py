"""Rationale generation: candidate classification + GPT-2 explanation decode
(port of the JAX package's ``models/rationale.py``; reference
``ChunkAlign_CLS_dec5_4``, modeling_vcr_chunkalign_v10.py:1319-1494).

- the global and ChunkAlign encoders (trainable in this family), CLS fusion
  through ``cls_ensemble`` (Linear(2D -> D)) and ``cls_layer_num`` reasoning
  layers over the 3·(T-1) ``[global ‖ seq ‖ chunk_hidden]`` memory with its
  padding masked;
- ``classifier: Linear(D, 2)`` per candidate row, CE against the binary
  target, and :func:`binary_to_mp` for the 4-way decision;
- the decoder memory ``[seq ‖ global ‖ chunk_hidden]`` (the order differs
  from the reasoning layers' memory) of each question's gold row (the
  label's, or the model's own argmax without one), and a GPT-2
  cross-attention decoder (models/gpt2.py) with the family's untied
  ``lm_head``; teacher-forced XE ignoring pad when ``expl_ids`` is given.

The keys are the reference's: ``global_enc.*``, ``seq_enc.*``,
``cls_ensemble``, ``cls_layer.N.*``, ``classifier``, ``dec.*`` and
``lm_head.weight``.  The encoders and heads compute in the encoder config's
dtype; the decoder in fp32 (models/gpt2.py).  :class:`RationaleForTraining`
puts the family behind the trainer's interface (train/).

One difference from the JAX forward, with the same values: the sequence
encoder's cross-modal layers return no attention probabilities.  The JAX
model asks for them and never reads them; without them every encoder layer
takes the stage-mask attention (12 launches per encoder on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_context_reasoning_torch.core.config import (
    ChunkAlignConfig,
    EncoderConfig,
    GPT2Config,
)
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.models.encoders import (
    ChunkAlignEncoder,
    EncoderOutput,
    GlobalImageEncoder,
)
from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder
from multimodal_context_reasoning_torch.models.layers import FeedForward, LayerNorm, Linear
from multimodal_context_reasoning_torch.models.modcr import init_dense_weights_
from multimodal_context_reasoning_torch.ops.masks import NEG_INF


def rationale_init_batch(
    encoder_config: EncoderConfig,
    gpt2_config: GPT2Config,
    spec,                       # BatchSpec (duck-typed: text_len / img_len)
    *,
    rows: int = 4,
    expl_len: int = 8,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """One representative input batch: one question's ``rows`` candidate
    rows and its explanation stream (``expl_ids`` [1, expl_len]), host numpy
    from ``seed`` (the JAX package's init recipe, the same draws)."""
    rng = np.random.default_rng(seed)
    B, T, I = rows, spec.text_len, spec.img_len
    return {
        "input_ids": np.asarray(
            rng.integers(4, encoder_config.vocab_size, size=(B, T)), np.int32),
        "text_mask": np.ones((B, T), np.float32),
        "img_feat": rng.normal(size=(B, I, encoder_config.img_feature_dim)).astype(np.float32),
        "img_mask": np.ones((B, I), np.float32),
        "chunk_mask": np.ones((B, T, T), np.float32),
        "gather_index": np.full((B, T), -1, np.int32),
        "expl_ids": np.asarray(
            rng.integers(2, gpt2_config.vocab_size, size=(1, expl_len)), np.int32),
        "expl_mask": np.ones((1, expl_len), np.float32),
    }


def binary_to_mp(logits: torch.Tensor, num_labels: int = 4) -> torch.Tensor:
    """Per-candidate binary logits -> multiple-choice probabilities:
    softmax over {false, true}, P(true), reshaped (-1, num_labels)."""
    return torch.softmax(logits.float(), dim=-1)[..., 1].reshape(-1, num_labels)


class ClsReasonLayer(FeedForward):
    """Single-query cross-attention of the CLS over a memory + BERT FFN
    (ClsLayer2 in its exact form): one head, raw dot products of
    ``cls_q_proj(cls)`` against ``align_k_proj(memory)`` (no 1/sqrt(d), only
    the temperature ``tau``), whose output is the values too; ``neg`` takes
    1 - softmax; dense + residual + LayerNorm, then the FFN.  Returns the
    attention weights (after dropout, as the reference), so it stays plain
    PyTorch."""

    def __init__(self, c: EncoderConfig):
        super().__init__(c)
        D, dt = c.hidden_size, c.torch_dtype
        self.cls_q_proj = Linear(D, D, dt)
        self.align_k_proj = Linear(D, D, dt)
        self.dense = Linear(D, D, dt)
        self.LayerNorm = LayerNorm(D, c.layer_norm_eps, dt)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, memory: torch.Tensor, cls: torch.Tensor,
                memory_bias: Optional[torch.Tensor], *, tau: float = 1.0,
                neg: bool = False):
        q = self.cls_q_proj(cls[:, None, :])                       # [B, 1, D]
        kv = self.align_k_proj(memory)                             # [B, M, D]
        scores = torch.einsum("bqd,bmd->bqm", q, kv).float()
        if memory_bias is not None:
            scores = scores + memory_bias[:, 0].float()
        probs = torch.softmax(scores / tau, dim=-1)
        if neg:
            probs = 1.0 - probs
        probs = self.dropout(probs)
        ctx = torch.einsum("bqm,bmd->bqd", probs.to(kv.dtype), kv)[:, 0]
        h = self.LayerNorm(self.dropout(self.dense(ctx)) + cls)
        return super().forward(h[:, None, :])[:, 0], probs[:, 0, :]


class CandidatePass(NamedTuple):
    """What :func:`classify_candidates` computes for each candidate row."""
    g: EncoderOutput                  # the global encoder's outputs
    s: EncoderOutput                  # the ChunkAlign encoder's outputs
    logits: torch.Tensor              # [B, 2] binary logits
    cls_loss: torch.Tensor            # scalar binary CE (0 without a label)
    mp_probs: torch.Tensor            # [Q, num_labels] choice probabilities
    tri_mask: torch.Tensor            # [B, 3(T-1)] the reasoning memory's mask
    cls_attn: torch.Tensor            # [B, 3(T-1)] summed reasoning-layer attention


def classify_candidates(model: nn.Module, batch: Dict[str, torch.Tensor], *,
                        output_attentions: bool) -> CandidatePass:
    """The candidate classifier shared by the rationale family and the
    stage-1 ChunkAlign classifier (models/chunkalign_cls.py): both encoders,
    ``cls_ensemble`` over their pooled vectors, the ``cls_layer`` stack over
    the ``[global ‖ seq ‖ chunk_hidden]`` memory of positions 1..T-1 with its
    padding masked, ``classifier``, the binary CE in fp32 and
    :func:`binary_to_mp`.  ``model`` carries those five children and
    ``num_labels`` / ``max_chunks``; ``output_attentions`` asks the
    ChunkAlign encoder's cross layers for their probabilities (their plain
    attention path)."""
    input_ids = batch["input_ids"]       # [B, T] (B = Q · num_labels)
    text_mask = batch["text_mask"]
    img_feat = batch["img_feat"]
    token_type_ids = batch.get("token_type_ids")
    T = input_ids.shape[1]

    g = model.global_enc(input_ids, img_feat, torch.cat([text_mask, batch["img_mask"]], dim=-1),
                         token_type_ids)
    s = model.seq_enc(input_ids, img_feat, text_mask, batch["img_mask"],
                      batch.get("chunk_mask"), batch["gather_index"], model.max_chunks,
                      token_type_ids, output_attentions=output_attentions)

    cls = model.cls_ensemble(torch.cat([g.pooled, s.pooled], dim=-1))
    memory = torch.cat([g.sequence[:, 1:T], s.sequence[:, 1:T], s.chunk_hidden[:, 1:T]], dim=1)
    word = text_mask[:, 1:T].float()
    tri_mask = torch.cat([word, word, word], dim=-1)
    memory_bias = ((1.0 - tri_mask) * NEG_INF)[:, None, None, :]
    attn_sum = torch.zeros(memory.shape[:2], device=memory.device)
    for layer in model.cls_layer:
        cls, probs = layer(memory, cls, memory_bias)
        attn_sum = attn_sum + probs.float()
    logits = model.classifier(cls)                             # [B, 2]

    cls_loss = torch.zeros((), device=logits.device)
    label = batch.get("label")
    if label is not None:
        logp = F.log_softmax(logits.float(), dim=-1)
        cls_loss = -logp.gather(1, label.reshape(-1).long()[:, None]).mean()
    return CandidatePass(g=g, s=s, logits=logits, cls_loss=cls_loss,
                         mp_probs=binary_to_mp(logits, model.num_labels), tri_mask=tri_mask,
                         cls_attn=attn_sum)


class RationaleOutput(NamedTuple):
    gen_loss: torch.Tensor            # scalar teacher-forcing XE
    cls_loss: torch.Tensor            # scalar binary CE
    mp_probs: torch.Tensor            # [Q, num_labels] choice probabilities
    cls_attn: torch.Tensor            # [B, M] summed reasoning-layer attention
    decoder_memory: torch.Tensor      # [Q, 3(T-1), D] gold-candidate memory
    decoder_memory_mask: torch.Tensor  # [Q, 3(T-1)]


class RationaleModel(nn.Module):
    def __init__(
        self,
        config: EncoderConfig,
        schedule: ChunkAlignConfig,
        gpt2: GPT2Config,
        *,
        num_labels: int = 4,
        cls_layer_num: int = 3,
        max_chunks: int = 40,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        c = config
        self.config = c
        self.num_labels = num_labels
        self.max_chunks = max_chunks
        # the family's decoder has its own untied head
        self.gpt2_config = dataclasses.replace(gpt2, tie_word_embeddings=False)
        with torch.device(resolve_device(device)):
            self.global_enc = GlobalImageEncoder(c)
            self.seq_enc = ChunkAlignEncoder(c, schedule)
            self.cls_ensemble = Linear(2 * c.hidden_size, c.hidden_size, c.torch_dtype)
            self.cls_layer = nn.ModuleList(ClsReasonLayer(c) for _ in range(cls_layer_num))
            self.classifier = Linear(c.hidden_size, 2, c.torch_dtype)
            self.lm_head = nn.Linear(gpt2.n_embd, gpt2.vocab_size, bias=False)
            self.dec = GPT2Decoder(self.gpt2_config, lm_head=self.lm_head)
        if generator is None:
            generator = torch.Generator(device=self.lm_head.weight.device).manual_seed(0)
        for name, child in self.named_children():
            if name not in ("dec", "lm_head"):
                init_dense_weights_(child, generator, c.initializer_range)
        self.dec.init_weights(generator)

    def cast_classifier_(self) -> "RationaleModel":
        """Cast every weight but the decoder's, once, to the encoders'
        compute dtype (the serving scorer's cast); the decoder stays fp32."""
        for name, child in self.named_children():
            if name not in ("dec", "lm_head"):
                child.to(self.config.torch_dtype)
        return self

    def forward(self, batch: Dict[str, torch.Tensor]) -> RationaleOutput:
        K = self.num_labels
        B, T = batch["input_ids"].shape
        p = classify_candidates(self, batch, output_attentions=False)
        g, s, label = p.g, p.s, batch.get("label")

        # decoder memory of each question's gold row
        dec_memory = torch.cat(
            [s.sequence[:, 1:T], g.sequence[:, 1:T], s.chunk_hidden[:, 1:T]], dim=1).detach()
        Q = B // K
        gold = (label.reshape(Q, K) if label is not None else p.mp_probs).argmax(dim=-1)
        rows = torch.arange(Q, device=gold.device) * K + gold
        mem_q, mask_q = dec_memory[rows], p.tri_mask[rows]

        gen_loss = torch.zeros((), device=p.logits.device)
        if "expl_ids" in batch:
            # one explanation stream per question
            expl = batch["expl_ids"]                              # [Q, Lg]
            gpt_labels = batch.get("gpt_labels", expl)
            lm_logits, _ = self.dec(expl, memory=mem_q.float(), memory_mask=mask_q,
                                    attn_mask=batch.get("expl_mask"))
            logp = F.log_softmax(lm_logits[:, :-1].float(), dim=-1)
            shift_labels = gpt_labels[:, 1:].long()
            nll = -logp.gather(-1, shift_labels[..., None])[..., 0]
            keep = (shift_labels != self.gpt2_config.pad_token_id).float()
            gen_loss = (nll * keep).sum() / torch.clamp(keep.sum(), min=1.0)

        return RationaleOutput(gen_loss=gen_loss, cls_loss=p.cls_loss, mp_probs=p.mp_probs,
                               cls_attn=p.cls_attn, decoder_memory=mem_q,
                               decoder_memory_mask=mask_q)


class RationaleTrainOutput(NamedTuple):
    loss: torch.Tensor        # optimized scalar: cls CE + gen_weight × XE
    align_loss: torch.Tensor  # 0: this family has no alignment term
    logits: torch.Tensor      # [Q, num_labels] log choice probabilities
    gen_loss: torch.Tensor
    cls_loss: torch.Tensor


class RationaleForTraining(nn.Module):
    """Trainer-interface facade over :class:`RationaleModel`.

    The reference ships the rationale family as modules only, and its
    forward returns the two losses apart (v10.py:1408).  The facade sums
    them, ``cls CE + gen_weight × teacher-forcing XE``, and gives the
    ``loss / logits / align_loss`` that train/step.py reads, so
    ``Trainer.fit`` drives the family unchanged.  Its children are the
    wrapped model's own, so its parameter names and state dict are
    ``RationaleModel``'s key for key: a trained state dict loads into
    ``serving/generator.py`` and ``interop/assemble.py`` as it is.

    The decoder memory is detached (as JAX's ``stop_gradient``), so the
    generation loss reaches the encoders only through the choice of the gold
    row, which carries no gradient: the encoders train on the CE alone."""

    def __init__(self, model: RationaleModel, *, gen_weight: float = 1.0):
        super().__init__()
        self.gen_weight = gen_weight
        self._wrapped = [model]            # a list, so it is not registered twice
        self._modules = model._modules     # the same children, under the same names

    @property
    def model(self) -> RationaleModel:
        return self._wrapped[0]

    def train(self, mode: bool = True) -> "RationaleForTraining":
        self.model.training = mode
        return super().train(mode)

    def forward(self, batch: Dict[str, torch.Tensor]) -> RationaleTrainOutput:
        out = self.model(batch)
        loss = out.cls_loss + self.gen_weight * out.gen_loss
        # log of the 4-way choice probabilities: the argmax _metrics needs,
        # finite for pad rows
        logits = torch.log(torch.clamp(out.mp_probs, min=1e-20))
        return RationaleTrainOutput(loss=loss, align_loss=torch.zeros_like(loss),
                                    logits=logits, gen_loss=out.gen_loss,
                                    cls_loss=out.cls_loss)
