"""Rationale generation: candidate classification + GPT-2 explanation decode
(port of the JAX package's ``models/rationale.py``, its classify forward;
reference ``ChunkAlign_CLS_dec5_4``, modeling_vcr_chunkalign_v10.py:1319-1494).

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
dtype; the decoder in fp32 (models/gpt2.py).

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
    (ClsLayer2 in its exact form): one head, raw unscaled dot products of
    ``cls_q_proj(cls)`` against ``align_k_proj(memory)``, whose output is
    the values too; dense + residual + LayerNorm, then the FFN.  Returns the
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
                memory_bias: Optional[torch.Tensor]):
        q = self.cls_q_proj(cls[:, None, :])                       # [B, 1, D]
        kv = self.align_k_proj(memory)                             # [B, M, D]
        scores = torch.einsum("bqd,bmd->bqm", q, kv).float()
        if memory_bias is not None:
            scores = scores + memory_bias[:, 0].float()
        probs = self.dropout(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("bqm,bmd->bqd", probs.to(kv.dtype), kv)[:, 0]
        h = self.LayerNorm(self.dropout(self.dense(ctx)) + cls)
        return super().forward(h[:, None, :])[:, 0], probs[:, 0, :]


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
        c, K = self.config, self.num_labels
        input_ids = batch["input_ids"]       # [B, T] (B = Q · num_labels)
        text_mask = batch["text_mask"]
        img_feat = batch["img_feat"]
        img_mask = batch["img_mask"]
        token_type_ids = batch.get("token_type_ids")
        B, T = input_ids.shape

        g = self.global_enc(input_ids, img_feat, torch.cat([text_mask, img_mask], dim=-1),
                            token_type_ids)
        s = self.seq_enc(input_ids, img_feat, text_mask, img_mask, batch.get("chunk_mask"),
                         batch["gather_index"], self.max_chunks, token_type_ids,
                         output_attentions=False)

        cls = self.cls_ensemble(torch.cat([g.pooled, s.pooled], dim=-1))
        # reasoning-layer memory: [global ‖ seq ‖ chunk_hidden] over positions 1..T-1
        memory = torch.cat([g.sequence[:, 1:T], s.sequence[:, 1:T], s.chunk_hidden[:, 1:T]],
                           dim=1)
        word = text_mask[:, 1:T].float()
        tri_mask = torch.cat([word, word, word], dim=-1)
        memory_bias = ((1.0 - tri_mask) * NEG_INF)[:, None, None, :]
        attn_sum = torch.zeros(memory.shape[:2], device=memory.device)
        for layer in self.cls_layer:
            cls, probs = layer(memory, cls, memory_bias)
            attn_sum = attn_sum + probs.float()
        logits = self.classifier(cls)                             # [B, 2]

        cls_loss = torch.zeros((), device=logits.device)
        label = batch.get("label")
        if label is not None:
            logp = F.log_softmax(logits.float(), dim=-1)
            cls_loss = -logp.gather(1, label.reshape(-1).long()[:, None]).mean()
        mp_probs = binary_to_mp(logits, K)

        # decoder memory of each question's gold row
        dec_memory = torch.cat(
            [s.sequence[:, 1:T], g.sequence[:, 1:T], s.chunk_hidden[:, 1:T]], dim=1).detach()
        Q = B // K
        gold = (label.reshape(Q, K) if label is not None else mp_probs).argmax(dim=-1)
        rows = torch.arange(Q, device=gold.device) * K + gold
        mem_q, mask_q = dec_memory[rows], tri_mask[rows]

        gen_loss = torch.zeros((), device=logits.device)
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

        return RationaleOutput(gen_loss=gen_loss, cls_loss=cls_loss, mp_probs=mp_probs,
                               cls_attn=attn_sum, decoder_memory=mem_q,
                               decoder_memory_mask=mask_q)
