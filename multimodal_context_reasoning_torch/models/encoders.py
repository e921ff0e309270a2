"""The two vision-language encoders of ModCR (port of the JAX package's
``models/encoders.py``).

- :class:`GlobalImageEncoder`: the Oscar-base global encoder (``BertImgModel``)
  over ``[CLS] premise [SEP] answer [SEP]`` ++ projected region features,
  full attention under a padding mask;
- :class:`ChunkAlignEncoder`: the ChunkAlign sequence encoder with the
  staged chunk -> full -> cross mask schedule and chunk-mean queries in the
  cross-modal phase.

Every layer gets the stage's :class:`MaskSpec`, so it runs the stage-mask
kernel unless it must return probabilities; the dense stage biases are built
only when some layer takes the plain path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import ChunkAlignConfig, EncoderConfig
from multimodal_context_reasoning_torch.models.layers import (
    BertEmbeddings,
    Linear,
    Pooler,
    TransformerLayer,
)
from multimodal_context_reasoning_torch.ops.chunk import chunk_mask_from_gather_index
from multimodal_context_reasoning_torch.ops.masks import (
    build_stage_biases,
    full_mask_spec,
    padding_bias,
    stage_mask_specs,
)


class EncoderOutput(NamedTuple):
    sequence: torch.Tensor                  # [B, L, D]
    pooled: torch.Tensor                    # [B, D]
    # [B, layers, H, L, L] attention probs of the requested layers
    attn_probs: Optional[torch.Tensor] = None
    # ChunkAlign only: hidden states at entry of the cross-modal phase
    chunk_hidden: Optional[torch.Tensor] = None


class ImageTextEmbeddings(nn.Module):
    """Token embeddings ++ projected image-region features (the embedding
    half of ``BertImgModel``: ``embeddings.*`` and ``img_embedding``).  The
    encoders subclass it, so these keys sit at the encoder's root as in the
    reference."""

    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.config = c
        self.embeddings = BertEmbeddings(c)
        self.img_embedding = Linear(c.img_feature_dim, c.hidden_size)
        if c.use_img_layernorm:
            self.img_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.img_layer_norm_eps)
        self.img_dropout = nn.Dropout(c.hidden_dropout_prob)

    def embed(self, input_ids, img_feats, token_type_ids=None, position_ids=None):
        text = self.embeddings(input_ids, token_type_ids, position_ids)
        img = self.img_embedding(img_feats)
        if self.config.use_img_layernorm:
            img = self.img_layer_norm(img)
        return torch.cat([text, self.img_dropout(img)], dim=1)


def _layer_stack(c: EncoderConfig) -> nn.ModuleDict:
    """``encoder.layer.N``: the encoder's transformer layers."""
    return nn.ModuleDict({"layer": nn.ModuleList(
        TransformerLayer(c) for _ in range(c.num_hidden_layers)
    )})


class GlobalImageEncoder(ImageTextEmbeddings):
    """Oscar-base global encoder (BertImgModel)."""

    def __init__(self, c: EncoderConfig):
        super().__init__(c)
        self.encoder = _layer_stack(c)
        self.pooler = Pooler(c.hidden_size)

    def forward(
        self,
        input_ids: torch.Tensor,          # [B, T]
        img_feats: torch.Tensor,          # [B, I, F]
        attention_mask: torch.Tensor,     # [B, T+I] {0,1} over text++img
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
    ) -> EncoderOutput:
        h = self.embed(input_ids, img_feats, token_type_ids, position_ids)
        bias = padding_bias(attention_mask)  # taken only under attention dropout
        spec = full_mask_spec(attention_mask, input_ids.shape[1])
        for layer in self.encoder.layer:
            h, _ = layer(h, bias, mask_spec=spec)
        return EncoderOutput(sequence=h, pooled=self.pooler(h))


class ChunkAlignEncoder(ImageTextEmbeddings):
    """ChunkAlign sequence encoder (SeqBertImgModel + staged schedule):

    - layers ``[0, chunk_layers_end)``: chunk stage,
    - layers ``[chunk_layers_end, full_layers_end)``: full padding mask,
    - the rest: cross stage with chunk-mean queries and the optional local
      residual; the hidden states entering the first of them are returned
      as ``chunk_hidden``, and their probabilities when
      ``output_attentions``.
    """

    def __init__(self, c: EncoderConfig, schedule: ChunkAlignConfig):
        super().__init__(c)
        self.encoder = _layer_stack(c)
        self.pooler = Pooler(c.hidden_size)
        self.schedule = schedule
        # SeqBertImgModel builds an edge_dense embedding it never uses in
        # forward; kept as a checkpoint key.
        self.edge_dense = nn.Embedding(1, c.hidden_size)

    def forward(
        self,
        input_ids: torch.Tensor,        # [B, T]
        img_feats: torch.Tensor,        # [B, I, F]
        text_mask: torch.Tensor,        # [B, T] {0,1}
        img_mask: torch.Tensor,         # [B, I] {0,1}
        chunk_mask: Optional[torch.Tensor],  # [B, T, T] {0,1}, or None
        gather_index: torch.Tensor,     # [B, T] chunk ids, -1 outside chunks
        num_chunks: int,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        *,
        output_attentions: bool = True,
    ) -> EncoderOutput:
        c, s = self.config, self.schedule
        B, T = input_ids.shape
        I = img_feats.shape[1]
        h = self.embed(input_ids, img_feats, token_type_ids, position_ids)

        specs = stage_mask_specs(text_mask, img_mask, gather_index)
        # Dense biases only where a layer takes the plain path: the cross
        # layers that return probabilities, or every layer under dropout.
        dense_all = self.training and c.attention_probs_dropout_prob > 0.0
        biases = (None, None, None)
        if dense_all or output_attentions:
            if chunk_mask is None:
                chunk_mask = chunk_mask_from_gather_index(gather_index, text_mask)
            biases = build_stage_biases(text_mask, img_mask, chunk_mask)
        full_gather = torch.cat(
            [gather_index, torch.full((B, I), -1, dtype=gather_index.dtype,
                                      device=gather_index.device)], dim=1,
        )

        chunk_hidden = None
        probs_cross = []
        for i, layer in enumerate(self.encoder.layer):
            if i < s.chunk_layers_end:
                stage, cq = 0, None
            elif i < s.full_layers_end:
                stage, cq = 1, None
            else:
                stage, cq = 2, full_gather
                if i == s.full_layers_end:
                    chunk_hidden = h
            is_cross = i >= s.full_layers_end
            out, probs = layer(
                h, biases[stage], chunk_query_index=cq, num_chunks=num_chunks,
                mask_spec=specs[stage], return_probs=is_cross and output_attentions,
            )
            if is_cross:
                if probs is not None:
                    probs_cross.append(probs)
                if s.add_local_residual:
                    out = out + h
            h = out

        if s.add_residual:
            h = h + chunk_hidden

        return EncoderOutput(
            sequence=h,
            pooled=self.pooler(h),
            attn_probs=torch.stack(probs_cross, dim=1) if probs_cross else None,
            chunk_hidden=chunk_hidden,
        )
