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
- :data:`fused_attention_spec` is the wrapper.  On a CUDA tensor it launches
  ``csrc/spec_attention.cu`` (built at first use, ops/build.py) or raises;
  it never falls back to the plain version there.  Its ``launches`` counter
  grows by one per kernel launch.
"""

from __future__ import annotations

import ctypes

import torch

STAGES = {"full": 0, "chunk": 1, "cross": 2}
MASK_PENALTY = 1e9
MAX_DH = 128


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


def spec_attention_plain(q, k, v, valid, gi, rowfull, *, stage: str,
                         text_len: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q [B, Lq, H, Dh], k and v
    [B, Lk, H, Dh] -> [B, Lq, H, Dh] in q's dtype."""
    lq, dh = q.shape[1], q.shape[3]
    vis = stage_visibility(valid, gi, rowfull, stage=stage, text_len=text_len, lq=lq)
    neg = (1.0 - vis) * MASK_PENALTY                            # one mask, all heads
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / dh ** 0.5)
    s = s - neg[:, None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


class SpecAttention:
    """Wrapper of ``csrc/spec_attention.cu``; see the module docstring."""

    def __init__(self):
        self.launches = 0
        self._lib = None

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
            lib.spec_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.spec_attention_smem_bytes.restype = ctypes.c_longlong
            self._lib = lib
        return self._lib

    def __call__(self, q, k, v, valid, gi, rowfull, *, stage: str,
                 text_len: int) -> torch.Tensor:
        if q.device.type == "cpu":
            return spec_attention_plain(q, k, v, valid, gi, rowfull,
                                        stage=stage, text_len=text_len)
        if q.device.type != "cuda":
            raise ValueError(f"fused_attention_spec: no kernel for {q.device}")
        return self.launch(q, k, v, valid, gi, rowfull, stage=stage,
                           text_len=text_len)

    def launch(self, q, k, v, valid, gi, rowfull, *, stage: str,
               text_len: int) -> torch.Tensor:
        """Launch the CUDA kernel; raises on anything it does not take,
        K/V beyond the card's shared memory per block included (the launch
        reports that)."""
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}")
        if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
            raise ValueError("q, k, v must be [B, L, H, Dh]")
        B, lq, H, dh = q.shape
        lk = k.shape[1]
        if k.shape != (B, lk, H, dh) or v.shape != k.shape:
            raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                             f"v {tuple(v.shape)}")
        if valid.shape != (B, lk) or gi.shape != (B, lk) or rowfull.shape != (B, lk):
            raise ValueError("valid, gi and rowfull must be [B, Lk]")
        if lq > lk or (stage != "full" and lq != lk):
            raise ValueError(f"stage {stage!r} with Lq={lq}, Lk={lk}")
        if dh > MAX_DH:
            raise ValueError(f"head dim {dh} > {MAX_DH}")
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype {q.dtype} not taken (float32 or bfloat16)")
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError("q, k and v must share one dtype")
        tensors = (q, k, v, valid, gi, rowfull)
        if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
            raise ValueError("all inputs must be on one CUDA device")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError("q, k, v need unit stride on the head dimension")
        if valid.dtype != torch.float32 or rowfull.dtype != torch.float32:
            raise TypeError("valid and rowfull must be float32")
        if gi.dtype != torch.int32:
            raise TypeError("gi must be int32")
        if not (valid.is_contiguous() and gi.is_contiguous()
                and rowfull.is_contiguous()):
            raise ValueError("valid, gi and rowfull must be contiguous")
        if B > 65535 or H > 65535:
            raise ValueError("batch and head count must be at most 65535")
        lib = self._library()
        is_bf16 = int(q.dtype == torch.bfloat16)

        out = torch.empty((B, lq, H, dh), dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.spec_attention_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                gi.data_ptr(), rowfull.data_ptr(), out.data_ptr(),
                B, lq, lk, H, dh,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                STAGES[stage], int(text_len), 1.0 / dh ** 0.5, is_bf16, stream,
            )
        if err != 0:
            smem = lib.spec_attention_smem_bytes(lk, dh, is_bf16)
            raise RuntimeError(f"spec_attention kernel launch failed: CUDA error {err} "
                               f"(K/V of Lk={lk}, Dh={dh} need {smem} B of shared memory "
                               "in one block)")
        self.launches += 1
        return out


fused_attention_spec = SpecAttention()
