"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's ``core/config.py`` (``EncoderConfig``,
``ChunkAlignConfig``, ``RobertaConfig``, ``GPT2Config``, ``CLIPConfig``,
``ModCRConfig``, ``TrainConfig``): every field is kept with its default, so
a config written by ``to_json`` on either side loads on the other.
``torch_dtype`` replaces ``jnp_dtype``.

Fields that steer the JAX program only are kept for that round trip and
have no effect here:

- ``use_pallas`` and ``mem_efficient_attention``: on a CUDA tensor the port
  always takes its hand-written kernels wherever attention needs neither
  probabilities nor dropout, the stage-mask attention with a mask spec and
  the dense-bias attention without one, each with the backward kernel
  (models/layers.py);
- ``GPT2Config.dtype``: the GPT-2 decoder computes in fp32 whatever it says,
  as the JAX package's does (its Dense, LayerNorm and Embed take no dtype).

``quantize="int8"`` (``ModCRConfig.with_quantize``) sends the projections and
FFN products of a tower through the W8A8 int8 route of ``models/layers.py``
(ops/quant.py); it is inference-only.

``TrainConfig.mesh_shape`` is the (data, model) mesh that ``Trainer``
builds over the process group when it is given none (parallel/mesh.py); the
CLIs set it from ``--mesh_data`` / ``--mesh_model``.

``RobertaConfig.remat``, ``remat_policy`` and ``scan_layers`` choose the
reasoner's branch as in the JAX package (models/roberta.py).

``ModCRConfig.reasoner`` and ``Lfm2MoeConfig`` are the port's own: the
LFM2 mixture-of-experts reasoner (models/lfm2.py) has no JAX twin.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

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
    use_pallas: bool = False     # no effect in the port (module docstring)
    # "none" | "int8": W8A8 products at the query/key/value, attention-out
    # and FFN sites (models/layers.py); the parameters do not change.
    quantize: str = "none"
    mem_efficient_attention: bool = False   # no effect in the port

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
    use_pallas: bool = False     # no effect in the port (module docstring)
    quantize: str = "none"       # see EncoderConfig.quantize
    mem_efficient_attention: bool = False   # no effect in the port
    # The reasoner's branch (models/roberta.py).
    scan_layers: bool = False
    remat: bool = False
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)


LFM2_8B_A1B_LAYER_TYPES = (
    ("conv", "conv", "full_attention") + ("conv", "conv", "conv", "full_attention") * 4
    + ("conv", "conv", "full_attention", "conv", "conv"))


@dataclasses.dataclass(frozen=True)
class Lfm2MoeConfig:
    """The LFM2 mixture-of-experts reasoner (models/lfm2.py), under the keys
    of its published ``config.json`` (LiquidAI/LFM2-8B-A1B, the defaults):
    gated short-convolution and grouped-query attention layers in the
    order of ``layer_types``; the first ``num_dense_layers`` with a dense
    SwiGLU FFN of ``intermediate_size``, the rest with a sparse MoE of
    ``num_experts`` experts of ``moe_intermediate_size``, top
    ``num_experts_per_tok``.  ``dtype`` is the compute dtype, as in the
    other configs; the router's scores stay fp32."""

    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 7168
    moe_intermediate_size: int = 1792
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_dense_layers: int = 2
    num_experts: int = 32
    num_experts_per_tok: int = 4
    layer_types: Tuple[str, ...] = LFM2_8B_A1B_LAYER_TYPES
    conv_L_cache: int = 3
    conv_bias: bool = False
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    norm_topk_prob: bool = True
    use_expert_bias: bool = True
    routed_scaling_factor: float = 1.0
    max_position_embeddings: int = 128000
    initializer_range: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for "
                             f"{self.num_hidden_layers} layers")
        kinds = set(self.layer_types) - {"conv", "full_attention"}
        if kinds:
            raise ValueError(f"unknown LFM2 layer types {sorted(kinds)}")
        if self.conv_bias:
            raise ValueError("conv_bias=True is not supported (LFM2 publishes none)")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_moe_layers(self) -> int:
        return self.num_hidden_layers - self.num_dense_layers

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """GPT-2 decoder with cross-attention for rationale generation (the
    vendored GPT-2: pre-LN blocks, fused qkv as Conv1D, optional
    cross-attention per block)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_inner: Optional[int] = None  # defaults to 4 * n_embd
    activation_function: str = "gelu_new"
    resid_pdrop: float = 0.1
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    add_cross_attention: bool = True
    pad_token_id: int = 50256  # GPT-2 has no pad; the reference uses the tokenizer's
    # True = HF GPT-2 (the LM head shares wte); the rationale family trains
    # a separate untied ``lm_head`` (models/rationale.py forces False).
    tie_word_embeddings: bool = True
    dtype: str = "float32"  # no effect (see the module docstring)

    @property
    def inner_dim(self) -> int:
        return self.n_inner if self.n_inner is not None else 4 * self.n_embd

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Frozen CLIP tower hyperparameters (ViT-B/16 defaults): the OpenAI CLIP
    the reference loads at import (run_PMR_ModCR.py:450) and its
    ``clip_model`` / ``clip_model_r`` ablations call inside the forward
    (modeling_ensemble.py:804-806,833-835).  models/clip.py builds both
    towers."""

    # Vision tower (ViT-B/16): 224² pixels, 16² patches -> 14×14 grid.
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12  # OpenAI convention: vision_width // 64
    # Text tower: 77-token causal transformer.
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    # Joint embedding space (both towers project here).
    embed_dim: int = 512
    # Compute dtype; parameters stay fp32.  The CLIP ensembles cast the
    # features to fp32 where the reference does (modeling_ensemble.py:810,846).
    dtype: str = "float32"

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @classmethod
    def tiny(cls) -> "CLIPConfig":
        """The JAX package's small test geometry (same topology: class token,
        pre-LN blocks, causal text tower, joint projection)."""
        return cls(
            image_size=32, patch_size=8, vision_width=32, vision_layers=2,
            vision_heads=4, vocab_size=512, context_length=16, text_width=32,
            text_layers=2, text_heads=4, embed_dim=24,
        )


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

    # The reasoner over the prefix: "roberta" (prefix-KV RoBERTa, ``roberta``)
    # or "lfm2_moe" (``lfm2``; the prefix enters as its first input
    # embeddings).  A config that leaves both at their defaults writes
    # neither to JSON, so it round-trips through the JAX package's loader.
    reasoner: str = "roberta"
    lfm2: Optional[Lfm2MoeConfig] = None

    def __post_init__(self):
        if self.reasoner not in ("roberta", "lfm2_moe"):
            raise ValueError(f"unknown reasoner {self.reasoner!r}")
        if (self.reasoner == "lfm2_moe") != (self.lfm2 is not None):
            raise ValueError('reasoner="lfm2_moe" goes with an lfm2 config, and only it')

    @property
    def seq_len(self) -> int:
        return self.text_len + self.img_len

    @property
    def total_prefix_len(self) -> int:
        return 2 * self.prefix_len

    @property
    def reasoner_hidden_size(self) -> int:
        """The width of the reasoner, of the prefix and of the scorer's input."""
        return self.lfm2.hidden_size if self.lfm2 is not None else self.roberta.hidden_size

    @property
    def reasoner_vocab_size(self) -> int:
        """The vocabulary the reasoner's token ids are drawn from."""
        return self.lfm2.vocab_size if self.lfm2 is not None else self.roberta.vocab_size

    @property
    def reasoner_dtype(self) -> torch.dtype:
        return self.lfm2.torch_dtype if self.lfm2 is not None else self.roberta.torch_dtype

    def with_dtype(self, dtype: str) -> "ModCRConfig":
        """Copy of this config with every submodel's compute dtype set."""
        return dataclasses.replace(
            self,
            global_encoder=dataclasses.replace(self.global_encoder, dtype=dtype),
            seq_encoder=dataclasses.replace(self.seq_encoder, dtype=dtype),
            roberta=dataclasses.replace(self.roberta, dtype=dtype),
            lfm2=None if self.lfm2 is None else dataclasses.replace(self.lfm2, dtype=dtype),
        )

    def with_quantize(self, mode: str) -> "ModCRConfig":
        """Copy with every tower's matmul quantization mode set ("none" |
        "int8", see EncoderConfig.quantize).  Inference-only; the LFM2
        reasoner has no int8 route."""
        if self.reasoner == "lfm2_moe" and mode != "none":
            raise ValueError(f"quantize={mode!r}: the LFM2 reasoner has no int8 route")
        return dataclasses.replace(
            self,
            global_encoder=dataclasses.replace(self.global_encoder, quantize=mode),
            seq_encoder=dataclasses.replace(self.seq_encoder, quantize=mode),
            roberta=dataclasses.replace(self.roberta, quantize=mode),
        )

    def to_json(self) -> str:
        raw = dataclasses.asdict(self)
        if self.reasoner == "roberta":
            del raw["reasoner"], raw["lfm2"]
        return json.dumps(raw, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ModCRConfig":
        raw = json.loads(text)
        raw["global_encoder"] = EncoderConfig(**raw.get("global_encoder", {}))
        raw["seq_encoder"] = EncoderConfig(**raw.get("seq_encoder", {}))
        raw["chunkalign"] = ChunkAlignConfig(**raw.get("chunkalign", {}))
        raw["roberta"] = RobertaConfig(**raw.get("roberta", {}))
        if raw.get("lfm2") is not None:
            raw["lfm2"] = Lfm2MoeConfig(**raw["lfm2"])
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


def pmr_training_config(*, dtype: str = "bfloat16", remat: bool = True) -> ModCRConfig:
    """The full-width PMR training geometry of the JAX package's
    ``scripts/train_real_pmr.py`` (its production branch: no alignment
    loss, RoBERTa remat "full") with every dropout at 0, the recipe of its
    real-data runs.  ``mem_efficient_attention`` is on, as ``--flash_attention``
    sets it, only so that the config matches the JAX one in a JSON round trip:
    the port takes the same attention path either way."""
    cfg = ModCRConfig(compute_alignment=False).with_dtype(dtype)
    drop = lambda c: dataclasses.replace(c, hidden_dropout_prob=0.0,
                                         attention_probs_dropout_prob=0.0)
    return dataclasses.replace(
        cfg, global_encoder=drop(cfg.global_encoder), seq_encoder=drop(cfg.seq_encoder),
        roberta=dataclasses.replace(drop(cfg.roberta), remat=remat,
                                    mem_efficient_attention=True),
        mapping_dropout=0.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: run_PMR_ModCR.py argparse
    defaults), field for field the JAX package's."""

    learning_rate: float = 1e-5       # :612
    seq_enc_lr_scale: float = 0.1     # seq_enc param group lr*0.1 (:127-135)
    weight_decay: float = 0.0         # parsed (0.05) but never passed to AdamW
    adam_epsilon: float = 1e-5        # :614
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    max_grad_norm: float = 1.0        # :615
    warmup_steps: int = 0             # :616
    scheduler: str = "linear"         # :617 ("constant" or "linear")
    num_train_epochs: int = 30        # :619
    max_steps: int = -1               # :621
    per_device_batch_size: int = 16   # :602 (examples; x4 candidates inside)
    gradient_accumulation_steps: int = 1  # :610
    seed: int = 88                    # :629
    valid_steps: int = 400            # :672
    epoch_begin: int = 2              # :671
    compute_dtype: str = "bfloat16"   # matmul/activation dtype; params stay fp32
    mesh_shape: Tuple[int, ...] = (1, 1)  # (data, model); Trainer's default mesh
    freeze_encoders: bool = True      # global + seq encoders run under no_grad

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        raw = json.loads(text)
        if "mesh_shape" in raw:
            raw["mesh_shape"] = tuple(raw["mesh_shape"])
        return cls(**raw)
