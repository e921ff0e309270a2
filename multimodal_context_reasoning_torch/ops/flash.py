"""Memory-efficient attention: the recompute-in-backward attention and the
CUDA backward kernel's wrapper (port of the JAX package's ``ops/flash.py``).

- :func:`flash_attention_bwd_plain` is ``_bwd_kernel``'s function step by
  step in PyTorch: recompute S and P in fp32, then dV = PᵀdO, dP = dO·Vᵀ,
  dS = P∘(dP − rowsum(dP∘P)), the head-summed fp32 dbias plane [B, Lq, Lk]
  taken before the scale, dQ = dS·K/√Dh and dK = dSᵀ·Q/√Dh, with P and dS
  rounded to the operand dtype before their products.  It is what a CPU
  tensor gets, and the oracle the kernel is held against.
- :data:`flash_attention_bwd` is the wrapper.  It calls the dispatcher op
  ``torch.ops.modcr_torch.flash_bwd`` (:data:`FLASH_BWD`), whose CUDA
  implementation launches ``csrc/flash_bwd.cu`` (built at first use,
  ops/build.py) or raises, and whose CPU implementation is the plain
  version; the tensors' device picks one.  The op returns four tensors, a
  schema having no optional output: the dbias plane is an empty fp32 tensor
  when ``want_dbias`` is false, and the wrapper gives ``None``. bf16 goes to
  the source's tensor-core kernels (K and V resident up to 192 keys; above,
  a key loop whose dK and dV sums pass between 128-row query tiles through
  an fp32 buffer this wrapper allocates), which take head dim 64 and rows
  that start on 16 bytes (checked here before launch); fp32 to its FP32-pipe
  kernels (K and V staged in shared memory while they fit, read from device
  memory above), which take head dims up to 128. Both take any key count;
  batch and head count are at most 65535 (the grid). Its ``launches``
  counter grows by one per kernel launch.
- :func:`mem_efficient_attention` is the dense-bias attention op
  (ops/fused_attention.py), whose gradient, registered here with
  ``torch.library.register_autograd``, saves only (q, k, v, bias) and runs
  the backward op above.  No [B, H, Lq, Lk] tensor outlives the call.  It
  takes no dropout: the model sends attention under dropout to the plain
  ``dot_product_attention``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodal_context_reasoning_torch.ops.fused_attention import (
    LIBRARY,
    bias_strides,
    call_op,
    check_bf16_limits,
    check_qkv,
    fused_attention,
)

_lib = torch.library.Library(LIBRARY, "FRAGMENT")
_lib.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor d_out, "
            "bool want_dbias) -> (Tensor, Tensor, Tensor, Tensor)")

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


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
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            lib.flash_attention_backward.restype = ctypes.c_int
            lib.flash_bwd_part_floats.argtypes = [ctypes.c_int] * 6
            lib.flash_bwd_part_floats.restype = ctypes.c_longlong
            self._lib = lib
        return self._lib

    def __call__(self, q, k, v, bias, d_out, *, want_dbias: bool = True) -> Grads:
        """(dq, dk, dv, dbias plane or None when ``want_dbias`` is False)."""
        dq, dk, dv, dbias = call_op(FLASH_BWD, (), q, k, v, bias, d_out, want_dbias)
        return dq, dk, dv, (dbias if want_dbias else None)

    def launch(self, q, k, v, bias, d_out, *, want_dbias: bool = True) -> Grads:
        """Launch the CUDA kernel; raises on anything it does not take
        (before launch) and on a refused launch."""
        B, lq, lk, H, dh = check_qkv(q, k, v, d_out)
        bias_ptr, *bstrides = bias_strides(bias, q, lk)
        is_bf16 = int(q.dtype == torch.bfloat16)
        if is_bf16:
            check_bf16_limits("bf16 attention backward", q, k, v, d_out)
        lib = self._library()
        strides = (ctypes.c_longlong * 15)(
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *d_out.stride()[:3],
            *bstrides)

        dq = torch.empty((B, lq, H, dh), dtype=q.dtype, device=q.device)
        dk = torch.empty((B, lk, H, dh), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
        dbias = (torch.zeros((B, lq, lk), dtype=torch.float32, device=q.device)
                 if want_dbias else None)
        n_part = lib.flash_bwd_part_floats(B, lq, lk, H, dh, is_bf16)
        part = (torch.empty(n_part, dtype=torch.float32, device=q.device)
                if n_part else None)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_backward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), bias_ptr,
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                dbias.data_ptr() if dbias is not None else 0,
                part.data_ptr() if part is not None else 0,
                B, lq, lk, H, dh, strides, 1.0 / dh ** 0.5, is_bf16, stream,
            )
        if err != 0:
            raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err} "
                               f"(B={B}, Lq={lq}, Lk={lk}, H={H}, Dh={dh}, {q.dtype})")
        self.launches += 1
        return dq, dk, dv, dbias


flash_attention_bwd = FlashAttentionBwd()


def reduce_to_bias(d4: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Sum a [B, H|1, Lq, Lk] gradient down to ``bias``'s shape
    (``_reduce_to_bias``, flash.py:63-69)."""
    axes = tuple(ax for ax in range(4) if bias.shape[ax] == 1 and d4.shape[ax] != 1)
    out = d4.sum(dim=axes, keepdim=True) if axes else d4
    return out.to(bias.dtype)


FLASH_BWD = torch.ops.modcr_torch.flash_bwd.default


def _bwd_cpu(q, k, v, bias, d_out, want_dbias):
    dq, dk, dv, dbias = flash_attention_bwd_plain(q, k, v, bias, d_out)
    if not want_dbias:
        dbias = q.new_empty((0,), dtype=torch.float32)
    return dq.contiguous(), dk.contiguous(), dv.contiguous(), dbias


def _bwd_cuda(q, k, v, bias, d_out, want_dbias):
    dq, dk, dv, dbias = flash_attention_bwd.launch(q, k, v, bias, d_out,
                                                   want_dbias=want_dbias)
    if dbias is None:
        dbias = q.new_empty((0,), dtype=torch.float32)
    return dq, dk, dv, dbias


def _bwd_fake(q, k, v, bias, d_out, want_dbias):
    B, lq, lk = q.shape[0], q.shape[1], k.shape[1]
    return (q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(k.shape),
            q.new_empty((B, lq, lk) if want_dbias else (0,), dtype=torch.float32))


_lib.impl("flash_bwd", _bwd_cpu, "CPU")
_lib.impl("flash_bwd", _bwd_cuda, "CUDA")
torch.library.register_fake(f"{LIBRARY}::flash_bwd", _bwd_fake, lib=_lib)


def _dense_setup(ctx, inputs, output):
    q, k, v, bias = inputs
    ctx.save_for_backward(q, k, v, bias)   # O(L·D) residuals only
    ctx.has_bias = bias is not None


def _dense_backward(ctx, d_out):
    q, k, v, bias = ctx.saved_tensors
    want_dbias = ctx.has_bias and ctx.needs_input_grad[3]
    dq, dk, dv, plane = FLASH_BWD(q, k, v, bias, d_out.contiguous(), want_dbias)
    d_bias = reduce_to_bias(plane[:, None], bias) if want_dbias else None
    return dq, dk, dv, d_bias


torch.library.register_autograd(f"{LIBRARY}::dense_attention", _dense_backward,
                                setup_context=_dense_setup, lib=_lib)


def mem_efficient_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ/√Dh + bias) v, differentiable in q, k, v and bias, saving
    only its inputs for the backward: on CUDA tensors the dense-bias kernel
    forward and the backward kernel, on CPU tensors their plain versions."""
    return fused_attention(q, k, v, bias)
