"""CLIP ViT towers (port of the JAX package's ``models/clip.py``).

The frozen OpenAI CLIP ViT-B/16 that the reference loads at import
(run_PMR_ModCR.py:450, ``clip.load('ViT-B/16')``) and calls inside its
``clip_model`` / ``clip_model_r`` ablations (modeling_ensemble.py:804-806,
833-835: ``encode_image`` on pixel batches, ``encode_text`` on 77-token id
batches).

The state dict has OpenAI's published layout (``visual.conv1.weight``,
``visual.transformer.resblocks.N.attn.in_proj_weight``,
``token_embedding.weight``, ``text_projection``, ``logit_scale``, ...), so a
published ``ViT-B-16.pt`` loads with ``strict=True`` after
interop/torch_bridge.py::convert_clip.  :class:`CLIP` subclasses the text
tower, so the text keys sit at its root as in OpenAI's layout.

The towers take the JAX package's inputs: pixels NHWC ``[B, S, S, 3]``
floats as data/clip_preprocess.py emits them (permuted once, before
``conv1``), ids ``[B, T]`` pooled at ``argmax(ids)`` (EOT has the highest id).

- Vision: Conv(3→W, P×P stride P, no bias) patchify → prepend the class
  embedding → add positional embeddings → ``ln_pre`` → pre-LN blocks →
  ``ln_post`` on the class token → ``proj`` [W, E].
- Text: token embedding → add positional embeddings → causal pre-LN blocks
  → ``ln_final`` → the hidden at each row's argmax id → ``text_projection``.
- Blocks: pre-LN, fused QKV (``in_proj_weight`` [3W, W]), QuickGELU MLP.

Attention is the plain ``ops/attention.py`` (softmax in fp32) with the causal
bias additive −1e4, as in the JAX package, which computes it outside Pallas:
no kernel runs here.  Parameters stay fp32; the compute dtype comes from
``CLIPConfig.dtype``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_context_reasoning_torch.core.config import CLIPConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.models.layers import Embedding, LayerNorm, Linear
from multimodal_context_reasoning_torch.ops.attention import dot_product_attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class _FusedAttention(nn.Module):
    """``attn.in_proj_weight`` [3W, W], ``attn.in_proj_bias`` and
    ``attn.out_proj`` (``nn.MultiheadAttention``'s keys)."""

    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width, dtype)


class ResidualAttentionBlock(nn.Module):
    """One pre-LN CLIP block: x += attn(ln_1(x)); x += mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.ln_1 = LayerNorm(width, 1e-5, dtype)
        self.attn = _FusedAttention(width, dtype)
        self.ln_2 = LayerNorm(width, 1e-5, dtype)
        self.mlp = nn.ModuleDict({"c_fc": Linear(width, 4 * width, dtype),
                                  "c_proj": Linear(4 * width, width, dtype)})

    def forward(self, x: torch.Tensor,                      # [B, L, W]
                bias: Optional[torch.Tensor] = None,        # broadcastable [B, H, L, L]
                ) -> torch.Tensor:
        B, L, W = x.shape
        dt = self.dtype
        h = self.ln_1(x)
        qkv = F.linear(h, self.attn.in_proj_weight.to(dt), self.attn.in_proj_bias.to(dt))
        q, k, v = (t.reshape(B, L, self.heads, W // self.heads) for t in qkv.split(W, dim=-1))
        out, _ = dot_product_attention(q, k, v, bias)
        x = x + self.attn.out_proj(out.reshape(B, L, W))
        h = quick_gelu(self.mlp.c_fc(self.ln_2(x)))
        return x + self.mlp.c_proj(h)


def _blocks(width: int, layers: int, heads: int, dtype: torch.dtype) -> nn.ModuleDict:
    """``transformer.resblocks.N``."""
    return nn.ModuleDict({"resblocks": nn.ModuleList(
        ResidualAttentionBlock(width, heads, dtype) for _ in range(layers))})


class CLIPVisionTower(nn.Module):
    """ViT image encoder → [B, embed_dim] (OpenAI ``VisualTransformer``)."""

    def __init__(self, c: CLIPConfig):
        super().__init__()
        self.config = c
        W, dt = c.vision_width, c.torch_dtype
        self.conv1 = nn.Conv2d(3, W, c.patch_size, stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(W))
        self.positional_embedding = nn.Parameter(torch.empty(c.grid_size ** 2 + 1, W))
        self.ln_pre = LayerNorm(W, 1e-5, dt)
        self.transformer = _blocks(W, c.vision_layers, c.vision_heads, dt)
        self.ln_post = LayerNorm(W, 1e-5, dt)
        self.proj = nn.Parameter(torch.empty(W, c.embed_dim))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: [B, image_size, image_size, 3] NHWC, normalized."""
        c = self.config
        dt = c.torch_dtype
        B, W = pixels.shape[0], c.vision_width
        x = F.conv2d(pixels.to(dt).permute(0, 3, 1, 2), self.conv1.weight.to(dt),
                     stride=c.patch_size)                          # [B, W, G, G]
        x = x.flatten(2).transpose(1, 2)                           # [B, G*G, W]
        x = torch.cat([self.class_embedding.to(dt).expand(B, 1, W), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding.to(dt))
        for block in self.transformer.resblocks:
            x = block(x)
        return self.ln_post(x[:, 0]) @ self.proj.to(dt)           # [B, E]


class CLIPTextTower(nn.Module):
    """Causal text encoder → [B, embed_dim] (OpenAI ``encode_text``)."""

    def __init__(self, c: CLIPConfig):
        super().__init__()
        self.config = c
        W, dt = c.text_width, c.torch_dtype
        self.token_embedding = Embedding(c.vocab_size, W, dt)
        self.positional_embedding = nn.Parameter(torch.empty(c.context_length, W))
        self.transformer = _blocks(W, c.text_layers, c.text_heads, dt)
        self.ln_final = LayerNorm(W, 1e-5, dt)
        self.text_projection = nn.Parameter(torch.empty(W, c.embed_dim))

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: [B, T], T ≤ context_length, 0-padded after the EOT
        token (data/clip_tokenizer.py); pooled at argmax(ids)."""
        dt = self.config.torch_dtype
        B, T = input_ids.shape
        x = self.token_embedding(input_ids) + self.positional_embedding.to(dt)[None, :T]
        # additive −1e4 (OpenAI fills −inf: the same after the fp32 softmax)
        causal = torch.ones(T, T, device=input_ids.device).tril()
        bias = ((1.0 - causal) * -1e4)[None, None]
        for block in self.transformer.resblocks:
            x = block(x, bias)
        x = self.ln_final(x)
        pooled = x[torch.arange(B, device=x.device), input_ids.argmax(dim=-1)]
        return pooled @ self.text_projection.to(dt)               # [B, E]

    forward = encode_text


class CLIP(CLIPTextTower):
    """Both towers and the temperature, with OpenAI's call surface:
    ``encode_image``, ``encode_text``, and a forward that returns the
    scaled cosine-similarity logit pair of OpenAI ``CLIP.forward``.

    Parameters are created on ``device`` (the GPU unless the caller passes
    ``device="cpu"``) and drawn from ``generator`` with the JAX package's
    init distributions."""

    def __init__(self, config: CLIPConfig, *, device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        with torch.device(resolve_device(device)):
            super().__init__(config)
            self.visual = CLIPVisionTower(config)
            # exp(logit_scale) is the temperature; OpenAI's init ln(1/0.07)
            self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's init: lecun-normal dense and conv kernels, zero
        biases, LayerNorm at 1 and 0, normal(W^-½) class, positional and
        projection parameters of the vision tower, normal(0.02) token and
        normal(0.01) positional embeddings of the text tower, normal(W^-½)
        text projection."""
        c = self.config
        if generator is None:
            generator = torch.Generator(device=self.logit_scale.device)
            generator.manual_seed(0)

        def lecun_(w: torch.Tensor, fan_in: int) -> None:
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_(m.weight, m.in_features)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, _FusedAttention):
                lecun_(m.in_proj_weight, m.in_proj_weight.shape[1])
                nn.init.zeros_(m.in_proj_bias)
        v = self.visual
        lecun_(v.conv1.weight, 3 * c.patch_size ** 2)
        for p in (v.class_embedding, v.positional_embedding, v.proj):
            nn.init.normal_(p, 0.0, c.vision_width ** -0.5, generator=generator)
        nn.init.normal_(self.token_embedding.weight, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.positional_embedding, 0.0, 0.01, generator=generator)
        nn.init.normal_(self.text_projection, 0.0, c.text_width ** -0.5, generator=generator)
        self.logit_scale.fill_(math.log(1.0 / 0.07))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual(pixels)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        img = self.encode_image(pixels)
        txt = self.encode_text(input_ids)
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        logits_per_image = self.logit_scale.exp().to(img.dtype) * img @ txt.t()
        return logits_per_image, logits_per_image.t()
