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
- :data:`fused_attention` is the wrapper.  It calls the dispatcher op
  ``torch.ops.modcr_torch.dense_attention`` (:data:`DENSE_ATTENTION`), whose
  CUDA implementation launches ``csrc/fused_attention.cu`` (built at first
  use, ops/build.py) or raises, and whose CPU implementation is the plain
  version: the tensors' device picks one, and a CUDA tensor never gets the
  plain version.  The op's fake implementation gives ``torch.export`` and
  fake tensors the output's shape, dtype and strides; its gradient
  (ops/flash.py) is the backward kernel's op.  bf16 goes to the source's
  tensor-core kernels (K and V resident up to 192 keys, a key loop above),
  which exist at head dims 64 and 128, and in slabs of 128 columns at any
  multiple of 128 above (the key loop at any key count, one block per
  output slab, the scores summed over every slab), and take rows that start on 16 bytes: every head is
  zero-padded to the next of those widths and the output sliced back
  (:func:`pad_bf16_heads`, :func:`bf16_width`), and the alignment is
  checked here before launch; fp32 goes to its FP32-pipe kernels (K and V
  staged in shared memory while they fit and the head is at most 256 wide,
  read from device memory otherwise, in slabs of 256 columns above 256).
  Both take any head width and any key count; batch and head count are at
  most 65535 (the grid).  Its ``launches`` counter grows by one per kernel
  launch, whatever the slab count.

When no input needs a gradient, the wrapper calls the op below the
autograd key, so serving and the frozen encoders add no autograd
bookkeeping to a launch.

The helpers :func:`check_qkv`, :func:`pad_bf16_heads`, :func:`unpad_heads`
and :func:`bias_strides` are shared with the backward kernel's wrapper
(ops/flash.py); all but the last with the stage-mask forward's
(ops/spec_attention.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Tuple

import torch

from multimodal_context_reasoning_torch.utils.profiling import count, counter, set_counter

# One namespace for the three kernels' ops; each module defines its own.
LIBRARY = "modcr_torch"
_lib = torch.library.Library(LIBRARY, "FRAGMENT")
_lib.define("dense_attention(Tensor q, Tensor k, Tensor v, Tensor? bias) -> Tensor")

DTYPES = (torch.float32, torch.bfloat16)
# The bf16 tensor-core kernels' head dims (the Dh template parameter of the
# tiles in csrc/attention_mma.cuh, shared by the dense-bias and stage-mask
# forwards, and of csrc/flash_bwd.cu's kernels), and the slab width their
# slab instances run a wider head in (kSlabDh, csrc/common.cuh).
BF16_HEAD_DIMS = (64, 128)
SLAB_DH = 128


def bf16_width(dh: int) -> int:
    """The head width a bf16 head of ``dh`` columns is launched at: the
    next of :data:`BF16_HEAD_DIMS`, or above 128 the next multiple of
    :data:`SLAB_DH`."""
    if dh <= BF16_HEAD_DIMS[-1]:
        return next(w for w in BF16_HEAD_DIMS if dh <= w)
    return -(-dh // SLAB_DH) * SLAB_DH


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q [B, Lq, H, Dh], k and v
    [B, Lk, H, Dh], bias broadcastable to [B, 1, Lq, Lk] -> [B, Lq, H, Dh]
    in q's dtype.  ``scale`` multiplies q kᵀ (default 1/√Dh)."""
    if scale is None:
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
    if q.dtype not in DTYPES:
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
    """Raise ``ValueError`` on a bf16 input whose rows (16 bytes and more)
    the tensor-core ``kernel``'s 16-byte copies cannot read.  ``others``
    (the output gradient) are shaped like q."""
    for name, t in zip(("q", "k", "v", "d_out"), (q, k, v, *others)):
        # one pass per tensor: this runs before every bf16 launch
        (sb, si, sh, _), (nb, ni, nh, _) = t.stride(), t.shape
        if (t.data_ptr() % 16 or (nb > 1 and sb % 8) or (ni > 1 and si % 8)
                or (nh > 1 and sh % 8)):
            raise ValueError(f"{kernel}: {name}'s rows are not 16-byte aligned "
                             f"(data_ptr % 16 = {t.data_ptr() % 16}, "
                             f"strides {tuple(t.stride())})")


def pad_bf16_heads(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   *others: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """q, k, v (and ``others``, the output gradient) for a bf16 launch of
    ``kernel``: at a head width the tensor cores take (:func:`bf16_width`),
    as they are; at any other, each zero-padded on the head dimension to
    the next such width, into a fresh contiguous buffer (16-byte aligned,
    as every allocation is), as the Pallas kernel pads its heads to the
    lanes.  Zero columns add exact zeros to q kᵀ, dO vᵀ and dS·K; the
    caller passes the true width's scale and slices the outputs back
    (:func:`unpad_heads`).  Then the rows' alignment is checked
    (:func:`check_bf16_limits`)."""
    dh = q.shape[-1]
    width = bf16_width(dh)
    ts = (q, k, v, *others)
    if width != dh:
        padded = []
        for t in ts:
            p = t.new_zeros((*t.shape[:-1], width))
            p[..., :dh] = t
            padded.append(p)
        ts = tuple(padded)
    check_bf16_limits(kernel, *ts)
    return ts


def unpad_heads(t: torch.Tensor, dh: int) -> torch.Tensor:
    """A kernel output at a padded head width, sliced back to the first
    ``dh`` columns (contiguous, as the op's fake implementation says)."""
    return t if t.shape[-1] == dh else t[..., :dh].contiguous()


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
        self._lib = None

    @property
    def launches(self) -> int:
        """Kernel launches so far in this process."""
        return counter("ops.fused_attention.launches")

    @launches.setter
    def launches(self, n: int) -> None:
        set_counter("ops.fused_attention.launches", n)

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
        return call_op(DENSE_ATTENTION, (q, k, v, bias), q, k, v, bias)

    def launch(self, q, k, v, bias) -> torch.Tensor:
        """Launch the CUDA kernel; raises on anything it does not take
        (before launch) and on a refused launch."""
        B, lq, lk, H, dh = check_qkv(q, k, v)
        bias_ptr, sbb, sbq, sbk = bias_strides(bias, q, lk)
        is_bf16 = int(q.dtype == torch.bfloat16)
        if is_bf16:
            q, k, v = pad_bf16_heads("bf16 attention forward", q, k, v)
        width = q.shape[-1]
        lib = self._library()

        out = torch.empty((B, lq, H, width), dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.dense_attention_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
                B, lq, lk, H, width,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], sbb, sbq, sbk,
                1.0 / dh ** 0.5, is_bf16, stream,
            )
        if err != 0:
            raise RuntimeError(f"fused_attention kernel launch failed: CUDA error {err} "
                               f"(B={B}, Lq={lq}, Lk={lk}, H={H}, Dh={dh}, {q.dtype})")
        count("ops.fused_attention.launches")
        return unpad_heads(out, dh)


_HOOK = threading.local()


@contextlib.contextmanager
def op_hook(fn):
    """Inside, on this thread, :func:`call_op` returns ``fn(op, diff_inputs,
    args)`` instead of calling the op (``None``: the op again).  A segmented
    graph capture (train/graphs.py) cuts here."""
    prev = getattr(_HOOK, "fn", None)
    _HOOK.fn = fn
    try:
        yield
    finally:
        _HOOK.fn = prev


def call_op(op, diff_inputs, *args):
    """``op(*args)``; below the autograd key unless one of ``diff_inputs``
    needs a gradient, so a call with nothing to differentiate records no
    autograd node and skips the op's Python autograd kernel.  Every call of
    the three ``modcr_torch`` ops comes through here (see :func:`op_hook`)."""
    hook = getattr(_HOOK, "fn", None)
    if hook is not None:
        return hook(op, diff_inputs, args)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in diff_inputs):
        return op(*args)
    with torch._C._AutoDispatchBelowAutograd():
        return op(*args)


fused_attention = DenseBiasAttention()
DENSE_ATTENTION = torch.ops.modcr_torch.dense_attention.default


def _dense_cpu(q, k, v, bias):
    # contiguous, as the kernel's output and the fake one are
    return fused_attention_plain(q, k, v, bias).contiguous()


def _dense_cuda(q, k, v, bias):
    return fused_attention.launch(q, k, v, bias)


def _dense_fake(q, k, v, bias):
    return q.new_empty(q.shape)


_lib.impl("dense_attention", _dense_cpu, "CPU")
_lib.impl("dense_attention", _dense_cuda, "CUDA")
torch.library.register_fake(f"{LIBRARY}::dense_attention", _dense_fake, lib=_lib)
