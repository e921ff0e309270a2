"""Stage-mask attention: the CUDA kernel's wrapper and its plain version.

Port of ``fused_attention_spec`` (multimodal_context_reasoning_tpu/ops/
pallas_attention.py, kernel ``_spec_kernel``)::

    out = softmax(q k^T / sqrt(Dh) - 1e9 * (1 - vis)) v

with the visibility mask ``vis`` [B, Lq, Lk] rebuilt from three per-token
vectors (``valid``, ``gi``, ``rowfull``, see ops/masks.py:MaskSpec) for a
static stage and text length.  Scores and softmax are fp32; P is rounded to
v's dtype before PV.  The masked cells get -1e9 here, where the dense path
(ops/masks.py) uses -10000: both give exact zeros on rows with a visible key,
and a uniform row where every key is masked.

- :func:`spec_attention_plain` computes it step by step in PyTorch.  It is
  what a CPU tensor gets, and the oracle the kernel is held against.
- :data:`fused_attention_spec` is the wrapper.  It calls the dispatcher op
  ``torch.ops.modcr_torch.spec_attention`` (:data:`SPEC_ATTENTION`; ``stage``
  a string, ``text_len`` an int), whose CUDA implementation launches
  ``csrc/spec_attention.cu`` (built at first use, ops/build.py) or raises,
  and whose CPU implementation is the plain version: the tensors' device
  picks one, and a CUDA tensor never gets the plain version.  A fake
  implementation gives ``torch.export`` the output's shape.  Two routes, by
  dtype:
  bf16 (the serving path and the training step's frozen encoders) goes to
  ``spec_attention_mma_kernel`` on the tensor cores, the dense-bias
  forward's tile (``csrc/attention_mma.cuh``) with the stage mask as its
  mask functor, K and V resident up to 192 keys and in a key loop above
  (``spec_attention_mma_long_kernel``); it exists at head dims 64 and 128,
  and in slabs of 128 columns at any multiple of 128 above, as the key
  loop at any key count (``spec_attention_mma_long_slab_kernel``: one block
  per output slab, the scores summed over every slab), and takes rows that
  start on 16 bytes: every head is zero-padded to the next of those
  widths, with the true width's scale, and the output sliced back
  (:func:`pad_bf16_heads`), the alignment checked here before launch.  fp32
  (the parity checks) goes to ``spec_attention_kernel`` on the FP32 pipes
  (K and V staged in shared memory while they fit and the head is at most
  256 wide, read from device memory otherwise, in slabs of 256 columns
  above 256).  Both take any head width and any key count; batch and head
  count are at most 65535 (the grid).  Its ``launches`` counter grows by one
  per kernel launch.
- What bounds the kernel on the card is bytes (q, k, v read once, out
  written once; about 95 FLOP/byte at the ModCR shapes, below the H100's
  ridge): both routes read q, k, v in place through their strides and
  rebuild the mask from O(Lk) vectors per block, so no mask or score plane
  reaches device memory; the bf16 route keeps each warp's score tile in
  registers and moves the products onto the tensor cores.
- The op's gradient (``torch.library.register_autograd``) saves only its
  inputs, rebuilds the mask as the bias plane ``-1e9 * (1 - vis)``
  (:func:`spec_bias`) and runs the backward op of ops/flash.py: the
  backward kernel on the card, its plain version on the CPU.  When none of
  q, k, v needs a gradient the wrapper calls the op below the autograd key,
  so no autograd node is recorded.  The JAX package's spec kernel has
  no VJP; its oracle for these gradients is autodiff of the dense path.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_context_reasoning_torch.ops.flash import FLASH_BWD
from multimodal_context_reasoning_torch.ops.fused_attention import (
    LIBRARY,
    call_op,
    check_qkv,
    pad_bf16_heads,
    unpad_heads,
)
from multimodal_context_reasoning_torch.utils.profiling import count, counter, set_counter

_lib = torch.library.Library(LIBRARY, "FRAGMENT")
_lib.define("spec_attention(Tensor q, Tensor k, Tensor v, Tensor valid, Tensor gi, "
            "Tensor rowfull, str stage, int text_len) -> Tensor")

STAGES = {"full": 0, "chunk": 1, "cross": 2}
MASK_PENALTY = 1e9


def stage_visibility(valid: torch.Tensor, gi: torch.Tensor, rowfull: torch.Tensor,
                     *, stage: str, text_len: int, lq: int) -> torch.Tensor:
    """[B, Lq, Lk] fp32 {0,1} visibility, the TPU kernel's mask algebra
    (pallas_attention.py ``_spec_kernel``) term for term."""
    lk = valid.shape[1]
    validf = valid.float()[:, None, :]                         # [B, 1, Lk]
    if stage == "full":
        return validf.expand(valid.shape[0], lq, lk)
    dev = valid.device
    posq = torch.arange(lq, device=dev)[:, None]
    posk = torch.arange(lk, device=dev)[None, :]
    gik = gi[:, None, :]
    giq = gi[:, :lq, None]
    rowqf = rowfull.float()[:, :lq, None]
    imgkf = (posk >= text_len).float()
    imgqf = (posq >= text_len).float()
    samef = ((giq == gik) & (giq >= 0)).float()
    eyef = (posq == posk).float()
    text_in = torch.clamp(samef + eyef + rowqf, max=1.0)
    text_rows = ((1.0 - imgkf) * text_in + imgkf) * validf
    if stage == "chunk":
        img_rows = imgkf * validf
    else:  # cross: image rows see only themselves, padding included
        img_rows = eyef
    return imgqf * img_rows + (1.0 - imgqf) * text_rows


def spec_attention_plain(q, k, v, valid, gi, rowfull, *, stage: str, text_len: int,
                         scale=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q [B, Lq, H, Dh], k and v
    [B, Lk, H, Dh] -> [B, Lq, H, Dh] in q's dtype.  ``scale`` multiplies
    q kᵀ (default 1/√Dh)."""
    lq, dh = q.shape[1], q.shape[3]
    if scale is None:
        scale = 1.0 / dh ** 0.5
    vis = stage_visibility(valid, gi, rowfull, stage=stage, text_len=text_len, lq=lq)
    neg = (1.0 - vis) * MASK_PENALTY                            # one mask, all heads
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s - neg[:, None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def spec_bias(valid: torch.Tensor, gi: torch.Tensor, rowfull: torch.Tensor, *,
              stage: str, text_len: int, lq: int) -> torch.Tensor:
    """The stage mask as the head-shared fp32 bias ``-1e9 * (1 - vis)`` the
    forward subtracts: [B, 1, 1, Lk] in the full stage, [B, 1, Lq, Lk] in the
    others.  Adding it gives the forward's scores bit for bit."""
    if stage == "full":
        vis = valid.float()[:, None, None, :]
    else:
        vis = stage_visibility(valid, gi, rowfull, stage=stage, text_len=text_len,
                               lq=lq)[:, None]
    return -((1.0 - vis) * MASK_PENALTY)


class SpecAttention:
    """Wrapper of ``csrc/spec_attention.cu``; see the module docstring."""

    def __init__(self):
        self._lib = None

    @property
    def launches(self) -> int:
        """Kernel launches so far in this process."""
        return counter("ops.spec_attention.launches")

    @launches.setter
    def launches(self, n: int) -> None:
        set_counter("ops.spec_attention.launches", n)

    def _library(self):
        if self._lib is None:
            from multimodal_context_reasoning_torch.ops.build import load_library

            lib, _, _ = load_library("spec_attention")
            lib.spec_attention_forward.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 9
                + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
            )
            lib.spec_attention_forward.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, q, k, v, valid, gi, rowfull, *, stage: str,
                 text_len: int) -> torch.Tensor:
        return call_op(SPEC_ATTENTION, (q, k, v), q, k, v, valid, gi, rowfull, stage,
                       text_len)

    def launch(self, q, k, v, valid, gi, rowfull, *, stage: str,
               text_len: int) -> torch.Tensor:
        """Launch the CUDA kernel; raises on anything it does not take
        (before launch) and on a refused launch."""
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}")
        lq, lk = q.shape[1], k.shape[1]
        if lq > lk or (stage != "full" and lq != lk):
            raise ValueError(f"stage {stage!r} with Lq={lq}, Lk={lk}")
        B, lq, lk, H, dh = check_qkv(q, k, v)
        if valid.shape != (B, lk) or gi.shape != (B, lk) or rowfull.shape != (B, lk):
            raise ValueError("valid, gi and rowfull must be [B, Lk]")
        if any(t.device != q.device for t in (valid, gi, rowfull)):
            raise ValueError("all inputs must be on one CUDA device")
        if valid.dtype != torch.float32 or rowfull.dtype != torch.float32:
            raise TypeError("valid and rowfull must be float32")
        if gi.dtype != torch.int32:
            raise TypeError("gi must be int32")
        if not (valid.is_contiguous() and gi.is_contiguous()
                and rowfull.is_contiguous()):
            raise ValueError("valid, gi and rowfull must be contiguous")
        is_bf16 = int(q.dtype == torch.bfloat16)
        if is_bf16:
            q, k, v = pad_bf16_heads("bf16 stage-mask attention forward", q, k, v)
        width = q.shape[-1]
        lib = self._library()

        out = torch.empty((B, lq, H, width), dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.spec_attention_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                gi.data_ptr(), rowfull.data_ptr(), out.data_ptr(),
                B, lq, lk, H, width,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                STAGES[stage], int(text_len), 1.0 / dh ** 0.5, is_bf16, stream,
            )
        if err != 0:
            raise RuntimeError(f"spec_attention kernel launch failed: CUDA error {err} "
                               f"(B={B}, Lq={lq}, Lk={lk}, H={H}, Dh={dh}, {q.dtype})")
        count("ops.spec_attention.launches")
        return unpad_heads(out, dh)


fused_attention_spec = SpecAttention()
SPEC_ATTENTION = torch.ops.modcr_torch.spec_attention.default


def _spec_cpu(q, k, v, valid, gi, rowfull, stage, text_len):
    # contiguous, as the kernel's output and the fake one are
    return spec_attention_plain(q, k, v, valid, gi, rowfull, stage=stage,
                                text_len=text_len).contiguous()


def _spec_cuda(q, k, v, valid, gi, rowfull, stage, text_len):
    return fused_attention_spec.launch(q, k, v, valid, gi, rowfull, stage=stage,
                                       text_len=text_len)


def _spec_fake(q, k, v, valid, gi, rowfull, stage, text_len):
    return q.new_empty(q.shape)


def _spec_setup(ctx, inputs, output):
    q, k, v, valid, gi, rowfull, stage, text_len = inputs
    ctx.save_for_backward(q, k, v, valid, gi, rowfull)   # O(L·D) only
    ctx.stage, ctx.text_len = stage, text_len


def _spec_backward(ctx, d_out):
    q, k, v, valid, gi, rowfull = ctx.saved_tensors
    bias = spec_bias(valid, gi, rowfull, stage=ctx.stage, text_len=ctx.text_len,
                     lq=q.shape[1])
    dq, dk, dv, _ = FLASH_BWD(q, k, v, bias, d_out.contiguous(), False)
    return dq, dk, dv, None, None, None, None, None


_lib.impl("spec_attention", _spec_cpu, "CPU")
_lib.impl("spec_attention", _spec_cuda, "CUDA")
torch.library.register_fake(f"{LIBRARY}::spec_attention", _spec_fake, lib=_lib)
torch.library.register_autograd(f"{LIBRARY}::spec_attention", _spec_backward,
                                setup_context=_spec_setup, lib=_lib)
