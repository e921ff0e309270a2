"""Dense-bias attention forward: the CUDA kernel's wrapper and its plain
version.

Port of ``fused_attention`` (multimodal_context_reasoning_tpu/ops/
pallas_attention.py, kernel ``_attn_kernel``)::

    out = softmax(q k^T / sqrt(Dh) + bias) v

with a head-shared additive fp32 bias [B|1, 1, Lq|1, Lk].  Scores and softmax
are fp32 (the products of bf16 inputs accumulate in fp32); P is rounded to
v's dtype before PV.

- :func:`fused_attention_plain` computes it step by step in PyTorch.  It is
  what a CPU tensor gets, and the oracle the kernel is held against.
- :data:`fused_attention` is the wrapper.  On a CUDA tensor it launches
  ``csrc/fused_attention.cu`` (built at first use, ops/build.py) or raises;
  it never falls back to the plain version there.  bf16 goes to the source's
  tensor-core kernels (K and V resident up to 192 keys, a key loop above),
  which take head dim 64 and rows that start on 16 bytes (checked here
  before launch); fp32 to its FP32-pipe kernels (K and V staged in shared
  memory while they fit, read from device memory above), which take head
  dims up to 128.  Both take any key count; batch and head count are at
  most 65535 (the grid).  Its ``launches`` counter grows by one per kernel
  launch.

The helpers :func:`check_qkv`, :func:`check_bf16_limits` and
:func:`bias_strides` are shared with the backward kernel's wrapper
(ops/flash.py); the first two with the stage-mask forward's
(ops/spec_attention.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

MAX_DH = 128   # kMaxDh, csrc/common.cuh
# The bf16 tensor-core kernels' head dim (kMmaDh in csrc/attention_mma.cuh,
# shared by the dense-bias and stage-mask forwards, and in csrc/flash_bwd.cu;
# their launchers refuse any other).
BF16_HEAD_DIM = 64


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q [B, Lq, H, Dh], k and v
    [B, Lk, H, Dh], bias broadcastable to [B, 1, Lq, Lk] -> [B, Lq, H, Dh]
    in q's dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *others: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """Check q [B, Lq, H, Dh], k and v [B, Lk, H, Dh] (and ``others`` shaped
    like q) for a kernel launch; returns (B, Lq, Lk, H, Dh)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, H, Dh]")
    B, lq, H, dh = q.shape
    lk = k.shape[1]
    if k.shape != (B, lk, H, dh) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if any(t.shape != q.shape for t in others):
        raise ValueError("the output gradient must be shaped like q")
    if dh > MAX_DH:
        raise ValueError(f"head dim {dh} > {MAX_DH}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} not taken (float32 or bfloat16)")
    if any(t.dtype != q.dtype for t in (k, v, *others)):
        raise TypeError("q, k, v (and the output gradient) must share one dtype")
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, *others)):
        raise ValueError("all inputs must be on one CUDA device")
    if any(t.stride(-1) != 1 for t in (q, k, v, *others)):
        raise ValueError("q, k, v need unit stride on the head dimension")
    if B > 65535 or H > 65535:
        raise ValueError("batch and head count must be at most 65535")
    return B, lq, lk, H, dh


def check_bf16_limits(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *others: torch.Tensor) -> None:
    """Raise ``ValueError`` on a bf16 input the tensor-core ``kernel`` does
    not take: another head dim, or a row (16 bytes and more) that its
    16-byte copies cannot read.  ``others`` (the output gradient) are shaped
    like q."""
    dh = q.shape[-1]
    if dh != BF16_HEAD_DIM:
        raise ValueError(f"{kernel}: head dim {dh} not taken "
                         f"(the kernel is built for {BF16_HEAD_DIM})")
    for name, t in zip(("q", "k", "v", "d_out"), (q, k, v, *others)):
        # one pass per tensor: this runs before every bf16 launch
        (sb, si, sh, _), (nb, ni, nh, _) = t.stride(), t.shape
        if (t.data_ptr() % 16 or (nb > 1 and sb % 8) or (ni > 1 and si % 8)
                or (nh > 1 and sh % 8)):
            raise ValueError(f"{kernel}: {name}'s rows are not 16-byte aligned "
                             f"(data_ptr % 16 = {t.data_ptr() % 16}, "
                             f"strides {tuple(t.stride())})")


def bias_strides(bias: Optional[torch.Tensor], q: torch.Tensor,
                 lk: int) -> Tuple[int, int, int, int]:
    """(data pointer, b, i, j element strides) of a head-shared fp32 bias
    [B|1, 1, Lq|1, Lk], with stride 0 on its broadcast dimensions; a null
    pointer for no bias."""
    if bias is None:
        return 0, 0, 0, 0
    B, lq = q.shape[0], q.shape[1]
    if bias.dim() != 4 or bias.shape[1] != 1:
        raise ValueError(f"bias must be head-shared [B|1, 1, Lq|1, Lk], got "
                         f"{tuple(bias.shape)}")
    if bias.shape[0] not in (1, B) or bias.shape[2] not in (1, lq) or bias.shape[3] != lk:
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                         f"[{B}, 1, {lq}, {lk}]")
    if bias.dtype != torch.float32:
        raise TypeError("bias must be float32")
    if bias.device != q.device:
        raise ValueError("bias must be on q's device")
    sb, _, si, sj = bias.stride()
    return (bias.data_ptr(), 0 if bias.shape[0] == 1 else sb,
            0 if bias.shape[2] == 1 else si, sj)


class DenseBiasAttention:
    """Wrapper of ``csrc/fused_attention.cu``; see the module docstring."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _library(self):
        if self._lib is None:
            from multimodal_context_reasoning_torch.ops.build import load_library

            lib, _, _ = load_library("fused_attention")
            lib.dense_attention_forward.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 12
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            lib.dense_attention_forward.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, q, k, v, bias) -> torch.Tensor:
        if q.device.type == "cpu":
            return fused_attention_plain(q, k, v, bias)
        if q.device.type != "cuda":
            raise ValueError(f"fused_attention: no kernel for {q.device}")
        return self.launch(q, k, v, bias)

    def launch(self, q, k, v, bias) -> torch.Tensor:
        """Launch the CUDA kernel; raises on anything it does not take
        (before launch) and on a refused launch."""
        B, lq, lk, H, dh = check_qkv(q, k, v)
        bias_ptr, sbb, sbq, sbk = bias_strides(bias, q, lk)
        is_bf16 = int(q.dtype == torch.bfloat16)
        if is_bf16:
            check_bf16_limits("bf16 attention forward", q, k, v)
        lib = self._library()

        out = torch.empty((B, lq, H, dh), dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.dense_attention_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
                B, lq, lk, H, dh,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], sbb, sbq, sbk,
                1.0 / dh ** 0.5, is_bf16, stream,
            )
        if err != 0:
            raise RuntimeError(f"fused_attention kernel launch failed: CUDA error {err} "
                               f"(B={B}, Lq={lq}, Lk={lk}, H={H}, Dh={dh}, {q.dtype})")
        self.launches += 1
        return out


fused_attention = DenseBiasAttention()
