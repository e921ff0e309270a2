"""PyTorch port: the stage-mask CUDA kernel against its plain version, on
the card.  Every test here needs a CUDA card and skips without one; the
file imports neither JAX nor the JAX package, so it runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``chip_smoke.py`` holds the kernel to its plain version at the full ModCR
shapes as well.)"""

import numpy as np
import pytest
import torch

from multimodal_context_reasoning_torch.ops.masks import stage_mask_specs
from multimodal_context_reasoning_torch.ops.spec_attention import (
    fused_attention_spec,
    spec_attention_plain,
)

pytestmark = pytest.mark.cuda

# fp32: only the order of summation differs; bf16: P is rounded before PV
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(card, B=3, T=21, I=9, H=4, Dh=32, seed=0):
    rng = np.random.default_rng(seed)
    text_mask = np.ones((B, T), np.float32)
    text_mask[1, T - 4:] = 0.0
    img_mask = np.ones((B, I), np.float32)
    img_mask[0, I - 2:] = 0.0
    gi = np.full((B, T), -1, np.int32)
    for t in range(1, T - 3, 2):
        gi[:, t] = gi[:, t + 1] = (t - 1) // 2
    gi[1, T - 4:] = -1
    specs = stage_mask_specs(*(torch.from_numpy(x).to(card)
                               for x in (text_mask, img_mask, gi)))
    qkv = [torch.from_numpy(rng.normal(size=(B, T + I, H, Dh)).astype(np.float32)).to(card)
           for _ in range(3)]
    return qkv, specs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage_idx", [0, 1, 2])
def test_kernel_matches_plain(card, dtype, stage_idx):
    (q, k, v), specs = _case(card)
    spec = specs[stage_idx]
    args = (q.to(dtype), k.to(dtype), v.to(dtype), spec.valid, spec.gi, spec.rowfull)
    before = fused_attention_spec.launches
    got = fused_attention_spec(*args, stage=spec.stage, text_len=spec.text_len)
    torch.cuda.synchronize()
    assert fused_attention_spec.launches == before + 1
    want = spec_attention_plain(*args, stage=spec.stage, text_len=spec.text_len)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])


def test_kernel_prefixed_full_stage_and_strided_inputs(card):
    """RoBERTa's geometry (Lk = 10 + Lq) with q/k/v read through strides."""
    rng = np.random.default_rng(1)
    B, Lq, P, H, Dh = 2, 19, 10, 3, 64
    Lk = P + Lq
    big = torch.from_numpy(rng.normal(size=(B, Lk, H, 3 * Dh)).astype(np.float32)).to(card)
    q, k, v = big[:, P:, :, :Dh], big[..., Dh:2 * Dh], big[..., 2 * Dh:]
    valid = torch.ones(B, Lk, device=card)
    valid[0, Lk - 3:] = 0.0
    valid[1, 2:4] = 0.0
    gi = torch.full((B, Lk), -1, dtype=torch.int32, device=card)
    rowfull = torch.zeros(B, Lk, device=card)
    got = fused_attention_spec(q, k, v, valid, gi, rowfull, stage="full", text_len=Lq)
    want = spec_attention_plain(q, k, v, valid, gi, rowfull, stage="full", text_len=Lq)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernel_fully_masked_rows_are_finite(card):
    (q, k, v), specs = _case(card)
    spec = specs[0]
    valid = torch.zeros_like(spec.valid)
    got = fused_attention_spec(q, k, v, valid, spec.gi, spec.rowfull, stage="chunk",
                               text_len=spec.text_len)
    want = spec_attention_plain(q, k, v, valid, spec.gi, spec.rowfull, stage="chunk",
                                text_len=spec.text_len)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernel_refuses_what_it_does_not_take(card):
    (q, k, v), specs = _case(card)
    spec = specs[1]
    vec = (spec.valid, spec.gi, spec.rowfull)
    with pytest.raises(TypeError):
        fused_attention_spec(q.half(), k.half(), v.half(), *vec, stage="full", text_len=21)
    with pytest.raises(TypeError):
        fused_attention_spec(q, k, v, spec.valid.double(), spec.gi, spec.rowfull,
                             stage="full", text_len=21)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros(*q.shape[:3], 160, device=card)
        fused_attention_spec(wide, wide, wide, *vec, stage="full", text_len=21)
    with pytest.raises(RuntimeError, match="shared memory"):
        long_kv = torch.zeros(q.shape[0], 4000, q.shape[2], q.shape[3], device=card)
        long_vec = (torch.ones(q.shape[0], 4000, device=card),
                    torch.full((q.shape[0], 4000), -1, dtype=torch.int32, device=card),
                    torch.zeros(q.shape[0], 4000, device=card))
        fused_attention_spec(q, long_kv, long_kv, *long_vec, stage="full", text_len=21)
    # the refused launch leaves no error behind for the next one
    got = fused_attention_spec(q, k, v, *vec, stage=spec.stage, text_len=21)
    want = spec_attention_plain(q, k, v, *vec, stage=spec.stage, text_len=21)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
