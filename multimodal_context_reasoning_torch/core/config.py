"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's ``core/config.py`` (``EncoderConfig``,
``ChunkAlignConfig``, ``RobertaConfig``, ``ModCRConfig``): every field is
kept with its default, so a config written by ``to_json`` on either side
loads on the other.  ``torch_dtype`` replaces ``jnp_dtype``.

Fields that steer the JAX program only are kept for that round trip and
have no effect here:

- ``use_pallas``: on a CUDA tensor the port always takes its hand-written
  stage-mask attention kernel (ops/spec_attention.py) wherever a layer has a
  mask spec and needs neither probabilities nor dropout;
- ``quantize``, ``mem_efficient_attention``, ``scan_layers``, ``remat`` and
  ``remat_policy``: training and int8 paths that later slices port.
"""

from __future__ import annotations

import dataclasses
import json

import torch


def _torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """BERT-family encoder hyperparameters (Oscar global encoder and the
    ChunkAlign sequence encoder)."""

    vocab_size: int = 30567  # bert-base-uncased 30522 + 45 <|det#|> tokens
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.3
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # Image-region stream: img_embedding Linear(2054, 768).
    img_feature_dim: int = 2054
    use_img_layernorm: bool = False
    img_layer_norm_eps: float = 1e-5
    # Computation dtype ("float32" | "bfloat16"); softmax and LayerNorm
    # statistics stay fp32.
    dtype: str = "float32"
    # No effect in the port (see the module docstring).
    use_pallas: bool = False
    quantize: str = "none"
    mem_efficient_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class ChunkAlignConfig:
    """Staged-attention schedule of the ChunkAlign sequence encoder: layers
    [0, chunk_layers_end) see chunk-internal text + image, layers
    [chunk_layers_end, full_layers_end) see everything, the rest are the
    cross-modal phase with chunk-mean queries and image-diagonal masking."""

    chunk_layers_end: int = 3
    full_layers_end: int = 9
    add_residual: bool = False
    add_local_residual: bool = False
    # CALeC reasoning layers over the fused CLS and their head count.
    cls_layer_num: int = 2
    cls_num_heads: int = 8
    # True masks padded memory positions in the CLS-fusion cross-attention;
    # False replicates the reference, which drops the mask.
    mask_fusion_memory: bool = True


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    """RoBERTa-large reasoner with KV-prefix injection."""

    vocab_size: int = 50310  # roberta-large 50265 + 45 <|det#|> tokens
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 514
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1  # position ids offset from it
    dtype: str = "float32"
    # No effect in the port (see the module docstring).
    use_pallas: bool = False
    quantize: str = "none"
    mem_efficient_attention: bool = False
    scan_layers: bool = False
    remat: bool = False
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class ModCRConfig:
    """Full ModCR composite: global + ChunkAlign encoders, CALeC fusion, two
    mapping networks and the prefix-RoBERTa reasoner."""

    global_encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    seq_encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    chunkalign: ChunkAlignConfig = dataclasses.field(default_factory=ChunkAlignConfig)
    roberta: RobertaConfig = dataclasses.field(default_factory=RobertaConfig)
    num_labels: int = 4
    prefix_len: int = 5  # per view; total prefix = 2 * prefix_len
    mapping_dropout: float = 0.1
    # "mapped" (production) | "promptfuse" (learnable 2-vector prefix)
    prefix_mode: str = "mapped"
    # False = the ablation without the ChunkAlign sequence encoder.
    use_seq_encoder: bool = True
    # Run the vision-prefix pass once per example instead of once per
    # candidate row (deterministic path only; same values).
    dedup_vision_prefix: bool = True
    # Compute the CALeC alignment loss; it needs the cross layers' attention
    # probabilities, which the fused kernel does not return.
    compute_alignment: bool = True

    text_len: int = 140
    img_len: int = 50
    roberta_len: int = 128
    max_chunks: int = 40

    @property
    def seq_len(self) -> int:
        return self.text_len + self.img_len

    @property
    def total_prefix_len(self) -> int:
        return 2 * self.prefix_len

    def with_dtype(self, dtype: str) -> "ModCRConfig":
        """Copy of this config with every submodel's compute dtype set."""
        return dataclasses.replace(
            self,
            global_encoder=dataclasses.replace(self.global_encoder, dtype=dtype),
            seq_encoder=dataclasses.replace(self.seq_encoder, dtype=dtype),
            roberta=dataclasses.replace(self.roberta, dtype=dtype),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ModCRConfig":
        raw = json.loads(text)
        raw["global_encoder"] = EncoderConfig(**raw.get("global_encoder", {}))
        raw["seq_encoder"] = EncoderConfig(**raw.get("seq_encoder", {}))
        raw["chunkalign"] = ChunkAlignConfig(**raw.get("chunkalign", {}))
        raw["roberta"] = RobertaConfig(**raw.get("roberta", {}))
        return cls(**raw)

    @classmethod
    def tiny(cls) -> "ModCRConfig":
        """The JAX package's tiny test geometry (same topology, small
        dims: 4 encoder layers as 1 chunk + 1 full + 2 cross-modal)."""
        enc = EncoderConfig(
            vocab_size=256, hidden_size=32, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128, img_feature_dim=20,
        )
        rob = RobertaConfig(
            vocab_size=256, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128,
        )
        sched = ChunkAlignConfig(chunk_layers_end=1, full_layers_end=2)
        return cls(
            global_encoder=enc, seq_encoder=enc, roberta=rob, chunkalign=sched,
            text_len=16, img_len=8, roberta_len=20, max_chunks=8,
        )
