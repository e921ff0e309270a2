"""Memory-efficient attention: the recompute-in-backward attention and the
CUDA backward kernel's wrapper (port of the JAX package's ``ops/flash.py``).

- :func:`flash_attention_bwd_plain` is ``_bwd_kernel``'s function step by
  step in PyTorch: recompute S and P in fp32, then dV = PᵀdO, dP = dO·Vᵀ,
  dS = P∘(dP − rowsum(dP∘P)), the head-summed fp32 dbias plane [B, Lq, Lk]
  taken before the scale, dQ = dS·K/√Dh and dK = dSᵀ·Q/√Dh, with P and dS
  rounded to the operand dtype before their products.  It is what a CPU
  tensor gets, and the oracle the kernel is held against.
- :data:`flash_attention_bwd` is the wrapper.  On a CUDA tensor it launches
  ``csrc/flash_bwd.cu`` (built at first use, ops/build.py) or raises; it
  never falls back to the plain version there.  bf16 goes to the source's
  tensor-core kernel, which takes head dim 64, at most 192 keys and rows
  that start on 16 bytes (checked here before launch); fp32 to its
  FP32-pipe kernel.  Its ``launches`` counter grows by one per kernel
  launch.
- :func:`mem_efficient_attention` is a ``torch.autograd.Function`` that
  saves only (q, k, v, bias): its forward is the dense-bias attention
  (ops/fused_attention.py), its backward the function above.  No
  [B, H, Lq, Lk] tensor outlives the call.  It takes no dropout: the model
  sends attention under dropout to the plain ``dot_product_attention``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodal_context_reasoning_torch.ops.fused_attention import (
    bias_strides,
    check_qkv,
    fused_attention,
)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]

# The bf16 kernel's limits (kMmaDh and kMaxLk in csrc/flash_bwd.cu, whose
# launcher refuses anything beyond them).
BF16_HEAD_DIM = 64
BF16_MAX_KEYS = 192


def flash_attention_bwd_plain(q, k, v, bias, d_out) -> Grads:
    """The kernel's function in plain PyTorch: q and d_out [B, Lq, H, Dh], k
    and v [B, Lk, H, Dh], a head-shared bias broadcastable to [B, 1, Lq, Lk]
    (or None) -> (dq, dk, dv in the operand dtype, dbias plane [B, Lq, Lk]
    fp32)."""
    dt = q.dtype
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), d_out.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof).to(dt)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dbias = ds.sum(dim=1)                              # before the scale
    ds = (ds * scale).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(dt)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).to(dt)
    return dq, dk, dv, dbias


def check_bf16_limits(q, k, v, d_out) -> None:
    """Raise ``ValueError`` on a bf16 input the tensor-core kernel does not
    take: another head dim, more keys than it holds in shared memory, or a
    row (16 bytes and more) that its 16-byte copies cannot read."""
    dh, lk = q.shape[-1], k.shape[1]
    if dh != BF16_HEAD_DIM:
        raise ValueError(f"bf16 attention backward: head dim {dh} not taken "
                         f"(the kernel is built for {BF16_HEAD_DIM})")
    if lk > BF16_MAX_KEYS:
        raise ValueError(f"bf16 attention backward: {lk} keys, at most {BF16_MAX_KEYS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("d_out", d_out)):
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st % 8 for st in strides):
            raise ValueError(f"bf16 attention backward: {name}'s rows are not 16-byte "
                             f"aligned (data_ptr % 16 = {t.data_ptr() % 16}, "
                             f"strides {tuple(t.stride())})")


class FlashAttentionBwd:
    """Wrapper of ``csrc/flash_bwd.cu``; see the module docstring."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _library(self):
        if self._lib is None:
            from multimodal_context_reasoning_torch.ops.build import load_library

            lib, _, _ = load_library("flash_bwd")
            lib.flash_attention_backward.argtypes = (
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            lib.flash_attention_backward.restype = ctypes.c_int
            lib.flash_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.flash_bwd_smem_bytes.restype = ctypes.c_longlong
            self._lib = lib
        return self._lib

    def __call__(self, q, k, v, bias, d_out, *, want_dbias: bool = True) -> Grads:
        """(dq, dk, dv, dbias plane or None when ``want_dbias`` is False)."""
        if q.device.type == "cpu":
            dq, dk, dv, dbias = flash_attention_bwd_plain(q, k, v, bias, d_out)
            return dq, dk, dv, (dbias if want_dbias else None)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
        return self.launch(q, k, v, bias, d_out, want_dbias=want_dbias)

    def launch(self, q, k, v, bias, d_out, *, want_dbias: bool = True) -> Grads:
        """Launch the CUDA kernel; raises on anything it does not take, a
        head beyond the card's shared memory per block included (the launch
        reports that)."""
        B, lq, lk, H, dh = check_qkv(q, k, v, d_out)
        bias_ptr, *bstrides = bias_strides(bias, q, lk)
        is_bf16 = int(q.dtype == torch.bfloat16)
        if is_bf16:
            check_bf16_limits(q, k, v, d_out)
        lib = self._library()
        strides = (ctypes.c_longlong * 15)(
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *d_out.stride()[:3],
            *bstrides)

        dq = torch.empty((B, lq, H, dh), dtype=q.dtype, device=q.device)
        dk = torch.empty((B, lk, H, dh), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
        dbias = (torch.zeros((B, lq, lk), dtype=torch.float32, device=q.device)
                 if want_dbias else None)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_backward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), bias_ptr,
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                dbias.data_ptr() if dbias is not None else 0,
                B, lq, lk, H, dh, strides, 1.0 / dh ** 0.5, is_bf16, stream,
            )
        if err != 0:
            smem = lib.flash_bwd_smem_bytes(lk, dh, is_bf16)
            raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err} "
                               f"(Lk={lk}, Dh={dh} in {q.dtype} need {smem} B of "
                               "shared memory in one block)")
        self.launches += 1
        return dq, dk, dv, dbias


flash_attention_bwd = FlashAttentionBwd()


def reduce_to_bias(d4: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Sum a [B, H|1, Lq, Lk] gradient down to ``bias``'s shape
    (``_reduce_to_bias``, flash.py:63-69)."""
    axes = tuple(ax for ax in range(4) if bias.shape[ax] == 1 and d4.shape[ax] != 1)
    out = d4.sum(dim=axes, keepdim=True) if axes else d4
    return out.to(bias.dtype)


class _MemEfficientAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)   # O(L·D) residuals only
        return fused_attention(q, k, v, bias)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias = ctx.saved_tensors
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, plane = flash_attention_bwd(q, k, v, bias, d_out.contiguous(),
                                                want_dbias=want_dbias)
        d_bias = reduce_to_bias(plane[:, None], bias) if want_dbias else None
        return dq, dk, dv, d_bias


def mem_efficient_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ/√Dh + bias) v, differentiable in q, k, v and bias, saving
    only its inputs for the backward: on CUDA tensors the dense-bias kernel
    forward and the backward kernel, on CPU tensors their plain versions."""
    return _MemEfficientAttention.apply(q, k, v, bias)
