"""The ModCR composite model (port of the JAX package's ``models/modcr.py``;
reference Abstract_Specific, modeling_ensemble.py:424-539).

1. Vision prefix: a frozen global-encoder pass over ``[CLS]`` + image
   regions; its CLS output feeds ``mapping_network_vision`` -> [B, 5, 1024].
2. Alignment prefix: frozen global + ChunkAlign passes fused by CALeC; the
   fused CLS feeds ``mapping_network_alignment`` -> [B, 5, 1024].
3. Reasoning: prefix-RoBERTa over the 10-vector prefix; its pooled output is
   scored by ``abst_confidence_scorer`` and reshaped to 4-way logits.  With
   ``config.reasoner == "lfm2_moe"`` the LFM2 reasoner (models/lfm2.py)
   takes the prefix as its first input embeddings instead, and its last
   valid token's normed state is scored; the mapping networks and the
   scorer take its width.
4. Losses: soft-target cross-entropy over the candidates, plus the CALeC
   alignment loss when ``compute_alignment``.

Both encoders run under ``torch.no_grad()`` when ``freeze_encoders`` (the
reference's no_grad, the JAX package's stop_gradient).  Dropout follows
``self.training``.  Parameters are created on ``device`` (the GPU unless the
caller passes ``device="cpu"``; CUDA without a card raises) and drawn from
``generator`` with the JAX package's init distributions: normal(0.02) for
embeddings, LayerNorm at 1/0, lecun-normal kernels and zero biases for
dense layers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.models.encoders import (
    ChunkAlignEncoder,
    GlobalImageEncoder,
)
from multimodal_context_reasoning_torch.models.fusion import ChunkAlignFusion
from multimodal_context_reasoning_torch.models.layers import Linear
from multimodal_context_reasoning_torch.models.lfm2 import Lfm2Reasoner
from multimodal_context_reasoning_torch.models.roberta import PrefixRoberta
from multimodal_context_reasoning_torch.utils.profiling import span


class MappingNetwork(nn.Sequential):
    """Dropout -> Linear(in -> 5·in) -> Tanh -> Dropout -> Linear(5·in ->
    prefix_len·out), reshaped to [B, prefix_len, out].  As a Sequential its
    linears are the reference's keys ``1.`` and ``4.``."""

    def __init__(self, hidden_size: int, out_size: int, prefix_len: int,
                 dropout: float = 0.1, compute_dtype: torch.dtype = torch.float32):
        super().__init__(
            nn.Dropout(dropout),
            Linear(hidden_size, hidden_size * prefix_len, compute_dtype),
            nn.Tanh(),
            nn.Dropout(dropout),
            Linear(hidden_size * prefix_len, out_size * prefix_len, compute_dtype),
        )
        self.prefix_len = prefix_len
        self.out_size = out_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).view(x.shape[0], self.prefix_len, self.out_size)


class ModCROutput(NamedTuple):
    loss: torch.Tensor            # scalar: 4-way soft CE
    logits: torch.Tensor          # [B, num_labels]
    align_loss: torch.Tensor      # scalar CALeC alignment loss
    abstract_loss: torch.Tensor   # scalar (== loss on the production path)


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss with float class-probability targets, mean over rows."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(targets.float() * logp).sum(dim=-1).mean()


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default Dense kernel init: truncated normal, variance 1/fan_in
    (the std is divided by the truncated normal's own std on [-2, 2])."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_dense_weights_(module: nn.Module, generator: torch.Generator, std: float) -> None:
    """The JAX package's init distributions over ``module``: lecun-normal
    kernels and zero biases for dense layers, normal(std) embeddings,
    LayerNorm at 1 and 0."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class ModCRModel(nn.Module):
    def __init__(self, config: ModCRConfig, *, freeze_encoders: bool = True,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = c
        self.freeze_encoders = freeze_encoders
        dev = resolve_device(device)
        with torch.device(dev):
            # ``calec`` is the fusion module carrying both encoders, as in
            # the reference composite (calec.global_enc.*, calec.seq_enc.*)
            self.calec = ChunkAlignFusion(c.global_encoder, c.chunkalign)
            self.calec.global_enc = GlobalImageEncoder(c.global_encoder)
            if c.use_seq_encoder:
                self.calec.seq_enc = ChunkAlignEncoder(c.seq_encoder, c.chunkalign)
            if c.reasoner == "lfm2_moe":
                self.reasoner = Lfm2Reasoner(c.lfm2)
            else:
                self.roberta = PrefixRoberta(c.roberta)
            width = c.reasoner_hidden_size
            mapping = (c.global_encoder.hidden_size, width,
                       c.prefix_len, c.mapping_dropout, c.global_encoder.torch_dtype)
            self.mapping_network_vision = MappingNetwork(*mapping)
            self.mapping_network_alignment = MappingNetwork(*mapping)
            if c.prefix_mode == "promptfuse":
                self.promptfuse = nn.Parameter(torch.empty(2, width))
            self.abst_confidence_scorer = Linear(width, 1, c.reasoner_dtype)
        # on the meta device (shapes only, weights assigned later) there is
        # nothing to draw
        if dev.type != "meta":
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:
            generator = torch.Generator(device=next(self.parameters()).device)
            generator.manual_seed(0)
        init_dense_weights_(self, generator, self.config.global_encoder.initializer_range)
        if self.config.reasoner == "lfm2_moe":
            self.reasoner.init_weights(generator)
        if self.config.prefix_mode == "promptfuse":
            nn.init.normal_(self.promptfuse, 0.0, 0.02, generator=generator)

    def forward(self, batch: Dict[str, torch.Tensor]) -> ModCROutput:
        c = self.config
        frozen = torch.no_grad() if self.freeze_encoders else contextlib.nullcontext()
        global_enc = self.calec.global_enc
        input_ids = batch["input_ids"]          # [N, T] (N = examples × K)
        text_mask = batch["text_mask"]          # [N, T]
        img_feat = batch["img_feat"]            # [N, I, F]
        img_mask = batch["img_mask"]            # [N, I]
        N, T = input_ids.shape
        K = c.num_labels

        # --- 1. Vision prefix over CLS + image.  The K candidate rows of an
        # example share it, so a dropout-free pass runs once per example.
        if c.prefix_mode != "promptfuse":
            with span("model.vision_prefix"):
                gc = c.global_encoder
                stochastic = self.training and (
                    gc.hidden_dropout_prob > 0.0 or gc.attention_probs_dropout_prob > 0.0)
                dedup = c.dedup_vision_prefix and not stochastic and N % K == 0 and N > K
                rows = slice(None, None, K) if dedup else slice(None)
                vis_mask = torch.cat([text_mask[rows, :1], img_mask[rows]], dim=-1)
                # contiguous: a bf16 feature table's rows would otherwise reach
                # the image projection as a strided view, which cuBLAS sums in
                # another order than the contiguous copy the fp32 path's cast
                # makes (the table and host paths then differ in the last bits)
                vis_feat = img_feat[rows].contiguous()
                with frozen:
                    vis_cls = global_enc(input_ids[rows, :1], vis_feat, vis_mask).sequence[:, 0]
                if dedup and self.training:
                    # repeat before the mapping network: its dropout stays per row
                    vis_cls = vis_cls.repeat_interleave(K, dim=0)
                prefix_vision = self.mapping_network_vision(vis_cls)
                if dedup and not self.training:
                    prefix_vision = prefix_vision.repeat_interleave(K, dim=0)

        # --- 2. Alignment prefix: global + ChunkAlign encoders + CALeC.
        with span("model.alignment"):
            full_mask = torch.cat([text_mask, img_mask], dim=-1)
            token_type_ids = batch.get("token_type_ids")
            with frozen:
                g_out = global_enc(input_ids, img_feat, full_mask, token_type_ids)
                if c.use_seq_encoder:
                    s_out = self.calec.seq_enc(
                        input_ids, img_feat, text_mask, img_mask, batch.get("chunk_mask"),
                        batch["gather_index"], c.max_chunks, token_type_ids,
                        output_attentions=c.compute_alignment,
                    )
                    seq_views = (s_out.sequence, s_out.pooled, s_out.chunk_hidden,
                                 s_out.attn_probs)
                    align_inputs = dict(align_pos=batch.get("align_pos"),
                                        total_label=batch.get("total_label"))
                else:
                    # the ablation without ChunkAlign: the global encoder stands
                    # in for every chunk-align view; no alignment supervision
                    seq_views = (g_out.sequence, g_out.pooled, g_out.sequence, None)
                    align_inputs = dict(align_pos=None, total_label=None)
            fused = self.calec(
                g_out.sequence, g_out.pooled, *seq_views, text_mask, T, **align_inputs
            )

        # --- 3. Reasoning over the prefix: prefix-RoBERTa, or LFM2.
        if c.reasoner == "lfm2_moe":
            with span("model.reasoner"):
                if c.prefix_mode == "promptfuse":
                    prefix_emb = self.promptfuse[None].expand(N, 2, c.lfm2.hidden_size)
                else:
                    prefix_align = self.mapping_network_alignment(fused.cls_ensem)
                    prefix_emb = torch.cat([prefix_vision, prefix_align], dim=1)
                pooled = self.reasoner(batch["r_input_ids"], batch["r_attention_mask"],
                                       prefix_emb)
        else:
            with span("model.roberta"):
                if c.prefix_mode == "promptfuse":
                    prefix_emb = self.promptfuse[None].expand(N, 2, c.roberta.hidden_size)
                else:
                    prefix_align = self.mapping_network_alignment(fused.cls_ensem)
                    prefix_emb = torch.cat([prefix_vision, prefix_align], dim=1)
                prompt_mask = torch.ones(prefix_emb.shape[:2], device=input_ids.device)
                r_out = self.roberta(
                    batch["r_input_ids"], batch["r_attention_mask"],
                    token_type_ids=batch.get("r_token_type_ids"),
                    prompt_embeddings=prefix_emb, prompt_mask=prompt_mask,
                )
            pooled = r_out.pooled

        # --- 4. Score + losses.
        with span("model.score"):
            logits = self.abst_confidence_scorer(pooled).view(-1, K)
            loss = torch.zeros((), device=logits.device)
            if batch.get("label") is not None:
                loss = soft_cross_entropy(logits, batch["label"].view(-1, K))
            return ModCROutput(loss=loss, logits=logits, align_loss=fused.align_loss,
                               abstract_loss=loss)
