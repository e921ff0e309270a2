"""PyTorch port: the CUDA kernels against their plain versions, on the
card: the stage-mask forward (and its autograd Function), the dense-bias
forward and the attention backward.  Every test here needs a CUDA card and
skips without one; the file imports neither JAX nor the JAX package, so it
runs where only the port's dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``chip_smoke.py`` holds the kernels to their plain versions at the full
ModCR shapes as well.)"""

import numpy as np
import pytest
import torch

from multimodal_context_reasoning_torch.ops.flash import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
    mem_efficient_attention,
)
from multimodal_context_reasoning_torch.ops.fused_attention import (
    fused_attention,
    fused_attention_plain,
)
from multimodal_context_reasoning_torch.ops.masks import stage_mask_specs
from multimodal_context_reasoning_torch.ops.spec_attention import (
    fused_attention_spec,
    spec_attention_plain,
    spec_bias,
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


# ---------------------------------------------------------------- dense-bias
# forward and attention backward (ops/fused_attention.py, ops/flash.py)

# backward: 1e-4 of each output's max |plain| in fp32 (fp32 atomics and the
# order of summation), 2e-2 in bf16 (P and dS are rounded before products)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _dense_case(card, B=3, Lq=19, P=10, H=4, Dh=64, seed=2, bias_shape="row"):
    rng = np.random.default_rng(seed)
    Lk = P + Lq
    q = torch.from_numpy(rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)).to(card)
    k, v = (torch.from_numpy(rng.normal(size=(B, Lk, H, Dh)).astype(np.float32)).to(card)
            for _ in range(2))
    valid = np.ones((B, Lk), np.float32)
    valid[0, Lk - 5:] = 0.0
    valid[2, P:P + 3] = 0.0
    if bias_shape == "row":     # RoBERTa's padding bias [B, 1, 1, Lk]
        bias = ((1.0 - valid) * -10000.0)[:, None, None, :]
    else:                       # a dense [B, 1, Lq, Lk] plane
        bias = rng.normal(size=(B, 1, Lq, Lk)).astype(np.float32)
    d_out = torch.from_numpy(rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)).to(card)
    return q, k, v, torch.from_numpy(bias).to(card), d_out


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1.0)
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_shape", ["row", "plane"])
def test_dense_forward_matches_plain(card, dtype, bias_shape):
    q, k, v, bias, _ = _dense_case(card, bias_shape=bias_shape)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = fused_attention.launches
    got = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), fused_attention_plain(q, k, v, bias).float(),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_shape", ["row", "plane", None])
def test_backward_matches_plain(card, dtype, bias_shape):
    q, k, v, bias, d_out = _dense_case(card, bias_shape=bias_shape or "row")
    bias = bias if bias_shape else None
    q, k, v, d_out = (t.to(dtype) for t in (q, k, v, d_out))
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, bias, d_out)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, bias, d_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _close(g, w, BWD_TOL[dtype])


def test_backward_strided_inputs_and_no_dbias(card):
    rng = np.random.default_rng(4)
    B, Lk, H, Dh = 2, 23, 3, 64
    big = torch.from_numpy(rng.normal(size=(B, Lk, H, 4 * Dh)).astype(np.float32)).to(card)
    q, k, v, d_out = (big[..., i * Dh:(i + 1) * Dh] for i in range(4))
    dq, dk, dv, dbias = flash_attention_bwd(q, k, v, None, d_out, want_dbias=False)
    assert dbias is None
    want = flash_attention_bwd_plain(q, k, v, None, d_out)
    for g, w in zip((dq, dk, dv), want):
        _close(g, w, BWD_TOL[torch.float32])


def test_mem_efficient_attention_grads_match_plain_autograd(card):
    q, k, v, bias, d_out = _dense_case(card, bias_shape="plane")
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    mem_efficient_attention(*leaves).backward(d_out)
    ref = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    fused_attention_plain(*ref).backward(d_out)
    for a, b in zip(leaves, ref):
        _close(a.grad, b.grad, BWD_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage_idx", [0, 1, 2])
def test_spec_function_grads_match_plain_autograd(card, dtype, stage_idx):
    (q, k, v), specs = _case(card, Dh=64)
    spec = specs[stage_idx]
    d_out = torch.randn(q.shape, device=card, generator=torch.Generator(card).manual_seed(0))
    vec = (spec.valid, spec.gi, spec.rowfull)
    kw = dict(stage=spec.stage, text_len=spec.text_len)
    leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    before = flash_attention_bwd.launches
    fused_attention_spec(*leaves, *vec, **kw).backward(d_out.to(dtype))
    assert flash_attention_bwd.launches == before + 1
    ref = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    spec_attention_plain(*ref, *vec, **kw).backward(d_out.to(dtype))
    for a, b in zip(leaves, ref):
        _close(a.grad, b.grad, BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_function_fully_masked_rows_have_finite_grads(card, dtype):
    (q, k, v), specs = _case(card, Dh=64)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    spec = specs[0]
    valid = torch.zeros_like(spec.valid)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fused_attention_spec(*leaves, valid, spec.gi, spec.rowfull, stage="chunk",
                         text_len=spec.text_len).sum().backward()
    bias = spec_bias(valid, spec.gi, spec.rowfull, stage="chunk",
                     text_len=spec.text_len, lq=q.shape[1])
    want = flash_attention_bwd_plain(q, k, v, bias, torch.ones_like(q))
    for a, w in zip(leaves, want):
        assert torch.isfinite(a.grad).all()
        _close(a.grad, w, BWD_TOL[dtype])


def test_new_kernels_refuse_what_they_do_not_take(card):
    q, k, v, bias, d_out = _dense_case(card)
    with pytest.raises(TypeError):
        fused_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(TypeError):
        fused_attention(q, k, v, bias.double())
    with pytest.raises(ValueError, match="head-shared"):
        fused_attention(q, k, v, bias.expand(-1, 4, -1, -1))
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention_bwd(q, k, v, bias, d_out.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(RuntimeError, match="shared memory"):
        long_kv = torch.zeros(q.shape[0], 4000, q.shape[2], q.shape[3], device=card)
        flash_attention_bwd(q, long_kv, long_kv, None, d_out)
    got = flash_attention_bwd(q, k, v, bias, d_out)   # no error left behind
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, bias, d_out)):
        _close(g, w, BWD_TOL[torch.float32])


# ---------------------------------------------------------------- the bf16
# backward's tensor-core kernel (csrc/flash_bwd.cu, flash_bwd_mma_kernel)

def _bf16(*ts):
    return [t.bfloat16() for t in ts]


def _rel_close(got, want, tol):
    """max |got - want| within ``tol`` of max |want|, with no floor."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("lq,prefix,bias_shape", [(190, 0, "plane"), (128, 10, "row")])
def test_bf16_backward_at_model_lengths(card, lq, prefix, bias_shape):
    """The chunk stage's Lq = Lk = 190 with a [B, 1, Lq, Lk] plane, and
    RoBERTa's Lk = 138 with a [B, 1, 1, Lk] row: dq, dk, dv and the dbias
    plane within 2e-2 of each output's max |plain|."""
    q, k, v, bias, d_out = _dense_case(card, Lq=lq, P=prefix, bias_shape=bias_shape)
    q, k, v, d_out = _bf16(q, k, v, d_out)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, bias, d_out)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, bias, d_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g).all()
        _rel_close(g, w, BWD_TOL[torch.bfloat16])


def test_bf16_backward_is_deterministic(card):
    """dq, dk and dv take no atomics: two launches agree bit for bit."""
    q, k, v, bias, d_out = _dense_case(card, Lq=128, P=10)
    q, k, v, d_out = _bf16(q, k, v, d_out)
    first = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)
    second = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)
    for a, b in zip(first[:3], second[:3]):
        assert torch.equal(a, b)


def test_bf16_backward_refuses_what_it_does_not_take(card):
    q, k, v, bias, d_out = _dense_case(card)
    q, k, v, d_out = _bf16(q, k, v, d_out)
    with pytest.raises(ValueError, match="16-byte"):
        wide = torch.zeros(*q.shape[:3], 72, dtype=torch.bfloat16, device=card)
        flash_attention_bwd(wide[..., 1:65], k, v, bias, d_out)
    with pytest.raises(ValueError, match="head dim"):
        narrow = [t[..., :32].contiguous() for t in (q, k, v, d_out)]
        flash_attention_bwd(narrow[0], narrow[1], narrow[2], bias, narrow[3])
    with pytest.raises(ValueError, match="at most 192"):
        long_kv = torch.zeros(q.shape[0], 4000, q.shape[2], q.shape[3],
                              dtype=torch.bfloat16, device=card)
        flash_attention_bwd(q, long_kv, long_kv, None, d_out)
    got = flash_attention_bwd(q, k, v, bias, d_out)   # no error left behind
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, bias, d_out)):
        _close(g, w, BWD_TOL[torch.bfloat16])
