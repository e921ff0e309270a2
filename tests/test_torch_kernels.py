"""PyTorch port: the CUDA kernels against their plain versions, on the
card: the stage-mask forward (both routes, and its op's gradient), the
dense-bias forward and the attention backward; and the int8 product of
``ops/quant.py`` against its plain accumulator.  Every test here needs a CUDA card and
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
from multimodal_context_reasoning_torch.ops.masks import full_mask_spec, stage_mask_specs
from multimodal_context_reasoning_torch.ops.quant import (
    int8_matmul,
    int8_mm,
    int8_mm_plain,
    quantize_symmetric,
)
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
    # bf16 at Dh 64, the tensor-core route's head dim
    (q, k, v), specs = _case(card, Dh=64 if dtype == torch.bfloat16 else 32)
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


@pytest.mark.parametrize("lq,prefix,bias_shape",
                         [(190, 0, "plane"), (128, 10, "row"), (128, 0, "row")])
def test_bf16_backward_at_model_lengths(card, lq, prefix, bias_shape):
    """The chunk stage's Lq = Lk = 190 with a [B, 1, Lq, Lk] plane, and
    RoBERTa's Lk = 138 (10 prefix keys) and Lk = 128 (no prefix) with a
    [B, 1, 1, Lk] row: dq, dk, dv and the dbias plane within 2e-2 of each
    output's max |plain|."""
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
    got = flash_attention_bwd(q, k, v, bias, d_out)   # no error left behind
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, bias, d_out)):
        _close(g, w, BWD_TOL[torch.bfloat16])


# ---------------------------------------------------------------- the bf16
# dense-bias forward's tensor-core kernel (csrc/fused_attention.cu,
# dense_attention_mma_kernel); relative error within 2e-2 of max |plain|

@pytest.mark.parametrize("lq,prefix,bias_shape",
                         [(190, 0, "plane"), (128, 10, "row"), (128, 0, "row")])
def test_bf16_dense_forward_at_model_lengths(card, lq, prefix, bias_shape):
    """The chunk stage's Lq = Lk = 190 with a [B, 1, Lq, Lk] plane, and
    RoBERTa's Lk = 138 (ModCR's 10 prefix keys) and Lk = 128 (the
    ensembles' RoBERTa, no prefix) with a [B, 1, 1, Lk] padding row."""
    q, k, v, bias, _ = _dense_case(card, Lq=lq, P=prefix, bias_shape=bias_shape)
    q, k, v = _bf16(q, k, v)
    before = fused_attention.launches
    got = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    _rel_close(got, fused_attention_plain(q, k, v, bias), TOL[torch.bfloat16])


@pytest.mark.parametrize("case", ["fully masked row", "strided views", "no bias"])
def test_bf16_dense_forward_cases(card, case):
    """A batch row with every key at -10000; q, k, v as aligned views into
    one [B, L, H, 3 Dh] tensor; no bias at all."""
    q, k, v, bias, _ = _dense_case(card, Lq=37, P=10)
    q, k, v = _bf16(q, k, v)
    if case == "fully masked row":
        bias[1] = -10000.0
    elif case == "strided views":
        big = torch.cat([torch.cat([q, q.flip(1)[:, :10]], dim=1), k, v], dim=-1)
        q, k, v = big[:, :q.shape[1], :, :64], big[..., 64:128], big[..., 128:]
        assert not q.is_contiguous() and not k.is_contiguous()
    else:
        bias = None
    got = fused_attention(q, k, v, bias)
    assert torch.isfinite(got).all()
    _rel_close(got, fused_attention_plain(q, k, v, bias), TOL[torch.bfloat16])


def test_bf16_dense_forward_is_deterministic(card):
    """No atomics: two launches agree bit for bit."""
    q, k, v, bias, _ = _dense_case(card, Lq=128, P=10)
    q, k, v = _bf16(q, k, v)
    assert torch.equal(fused_attention(q, k, v, bias), fused_attention(q, k, v, bias))


def test_bf16_dense_forward_refuses_what_it_does_not_take(card):
    q, k, v, bias, _ = _dense_case(card)
    q, k, v = _bf16(q, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        wide = torch.zeros(*q.shape[:3], 72, dtype=torch.bfloat16, device=card)
        fused_attention(wide[..., 1:65], k, v, bias)
    with pytest.raises(ValueError, match="head dim"):
        narrow = [t[..., :32].contiguous() for t in (q, k, v)]
        fused_attention(*narrow, bias)
    got = fused_attention(q, k, v, bias)   # no error left behind
    _close(got, fused_attention_plain(q, k, v, bias), TOL[torch.bfloat16])


# ---------------------------------------------------------------- the bf16
# stage-mask forward's tensor-core kernel (csrc/spec_attention.cu,
# spec_attention_mma_kernel on the tile of csrc/attention_mma.cuh)

@pytest.mark.parametrize("stage_idx", [0, 2])
def test_bf16_spec_chunk_and_cross_stages_at_l190(card, stage_idx):
    """The encoder's chunk and cross stages at Lq = Lk = 190 (140 text + 50
    regions, 12 heads of 64), ragged text, chunks and regions."""
    (q, k, v), specs = _case(card, B=2, T=140, I=50, H=12, Dh=64, seed=3)
    spec = specs[stage_idx]
    q, k, v = _bf16(q, k, v)
    vec = (spec.valid, spec.gi, spec.rowfull)
    kw = dict(stage=spec.stage, text_len=spec.text_len)
    before = fused_attention_spec.launches
    got = fused_attention_spec(q, k, v, *vec, **kw)
    torch.cuda.synchronize()
    assert fused_attention_spec.launches == before + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), spec_attention_plain(q, k, v, *vec, **kw).float(),
                               rtol=0, atol=TOL[torch.bfloat16])


def test_bf16_spec_full_stage_prefixed_and_strided(card):
    """RoBERTa's full stage, Lq 128 against Lk 138 (10 prefix slots), with
    q, k, v as aligned views into one [B, Lk, H, 3 Dh] tensor."""
    rng = np.random.default_rng(6)
    B, Lq, P, H, Dh = 3, 128, 10, 16, 64
    Lk = P + Lq
    big = torch.from_numpy(rng.normal(size=(B, Lk, H, 3 * Dh)).astype(np.float32))
    big = big.to(card, torch.bfloat16)
    q, k, v = big[:, P:, :, :Dh], big[..., Dh:2 * Dh], big[..., 2 * Dh:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    valid = torch.ones(B, Lk, device=card)
    valid[0, P + 100:] = 0.0
    valid[2, P + 20:] = 0.0
    gi = torch.full((B, Lk), -1, dtype=torch.int32, device=card)
    rowfull = torch.zeros(B, Lk, device=card)
    got = fused_attention_spec(q, k, v, valid, gi, rowfull, stage="full", text_len=Lq)
    want = spec_attention_plain(q, k, v, valid, gi, rowfull, stage="full", text_len=Lq)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[torch.bfloat16])


def _roberta_no_prefix(card, B=6, L=128, H=16, Dh=64, seed=8):
    """RoBERTa with no prefix, as the ensembles run it: Lq = Lk = 128, the
    full stage's spec of ``full_mask_spec`` over ragged padding masks (one
    row full, one of 5 tokens)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, L), np.float32)
    for b, n in enumerate([L, 5, *rng.integers(6, L, B - 2)]):
        mask[b, :n] = 1.0
    spec = full_mask_spec(torch.from_numpy(mask).to(card), L)
    qkv = [torch.from_numpy(rng.normal(size=(B, L, H, Dh)).astype(np.float32)).to(card)
           for _ in range(3)]
    return qkv, spec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_roberta_no_prefix_matches_plain(card, dtype):
    """The stage-mask forward at (B, 128, 128, 16, 64), no prefix keys."""
    (q, k, v), spec = _roberta_no_prefix(card)
    args = (q.to(dtype), k.to(dtype), v.to(dtype), spec.valid, spec.gi, spec.rowfull)
    kw = dict(stage=spec.stage, text_len=spec.text_len)
    assert spec.stage == "full" and spec.valid.shape == (6, 128)
    before = fused_attention_spec.launches
    got = fused_attention_spec(*args, **kw)
    torch.cuda.synchronize()
    assert fused_attention_spec.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), spec_attention_plain(*args, **kw).float(),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_function_grads_roberta_no_prefix(card, dtype):
    """The stage-mask Function's gradients there (RoBERTa without remat)
    against autograd of its plain version."""
    (q, k, v), spec = _roberta_no_prefix(card, seed=9)
    d_out = torch.randn(q.shape, device=card, generator=torch.Generator(card).manual_seed(1))
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


@pytest.mark.parametrize("stage", ["chunk", "full", "cross"])
def test_bf16_spec_fully_masked_rows(card, stage):
    """A batch row with no valid key: every row of it (every text row in the
    cross stage) adds -1e9 to each key and comes out uniform, as in the
    plain version."""
    (q, k, v), specs = _case(card, Dh=64)
    q, k, v = _bf16(q, k, v)
    spec = specs[0]
    valid = spec.valid.clone()
    valid[1] = 0.0
    kw = dict(stage=stage, text_len=spec.text_len)
    got = fused_attention_spec(q, k, v, valid, spec.gi, spec.rowfull, **kw)
    want = spec_attention_plain(q, k, v, valid, spec.gi, spec.rowfull, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[torch.bfloat16])


@pytest.mark.parametrize("stage_idx", [0, 1])
def test_bf16_spec_is_deterministic(card, stage_idx):
    """No atomics: two launches agree bit for bit."""
    (q, k, v), specs = _case(card, B=2, T=140, I=50, H=12, Dh=64, seed=4)
    spec = specs[stage_idx]
    args = (*_bf16(q, k, v), spec.valid, spec.gi, spec.rowfull)
    kw = dict(stage=spec.stage, text_len=spec.text_len)
    assert torch.equal(fused_attention_spec(*args, **kw), fused_attention_spec(*args, **kw))


def test_bf16_spec_refuses_what_it_does_not_take(card):
    """Head dim 32 raises ValueError before launch; the next launch is
    clean."""
    (q, k, v), specs = _case(card, Dh=64)
    q, k, v = _bf16(q, k, v)
    spec = specs[1]
    vec = (spec.valid, spec.gi, spec.rowfull)
    before = fused_attention_spec.launches
    with pytest.raises(ValueError, match="head dim"):
        narrow = [t[..., :32].contiguous() for t in (q, k, v)]
        fused_attention_spec(*narrow, *vec, stage="full", text_len=spec.text_len)
    assert fused_attention_spec.launches == before
    got = fused_attention_spec(q, k, v, *vec, stage="full", text_len=spec.text_len)
    want = spec_attention_plain(q, k, v, *vec, stage="full", text_len=spec.text_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[torch.bfloat16])


# ---------------------------------------------------------------- long keys:
# every route past the bf16 kernels' resident 192 keys (the key-looped
# instances) and past the fp32 kernels' shared memory (about 208 keys for the
# backward, 411 and 417 for the forwards: the streaming kernels).  240 keys
# are the encoders at --max_img_seq_length 100 (140 text + 100 regions).

LONG = (240, 520)
DTYPES = (torch.float32, torch.bfloat16)


def _long_spec_case(card, L, seed=7):
    """The encoders' geometry at L = 140 text + (L - 140) regions, ragged."""
    return _case(card, B=2, T=140, I=L - 140, H=4, Dh=64, seed=seed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", LONG)
@pytest.mark.parametrize("stage_idx", [0, 1, 2])
def test_long_keys_spec_matches_plain(card, dtype, L, stage_idx):
    (q, k, v), specs = _long_spec_case(card, L)
    spec = specs[stage_idx]
    args = (q.to(dtype), k.to(dtype), v.to(dtype), spec.valid, spec.gi, spec.rowfull)
    kw = dict(stage=spec.stage, text_len=spec.text_len)
    before = fused_attention_spec.launches
    got = fused_attention_spec(*args, **kw)
    torch.cuda.synchronize()
    assert fused_attention_spec.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), spec_attention_plain(*args, **kw).float(),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", LONG)
@pytest.mark.parametrize("bias_shape", ["row", "plane"])
def test_long_keys_dense_forward_matches_plain(card, dtype, L, bias_shape):
    """Lq = 128 against Lk = L (the row bias, RoBERTa's layout) and
    Lq = Lk = L (the plane)."""
    lq = 128 if bias_shape == "row" else L
    q, k, v, bias, _ = _dense_case(card, Lq=lq, P=L - lq, bias_shape=bias_shape)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = fused_attention.launches
    got = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), fused_attention_plain(q, k, v, bias).float(),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", LONG)
@pytest.mark.parametrize("lq_kind", ["one tile", "square"])
def test_long_keys_backward_with_dbias_matches_plain(card, dtype, L, lq_kind):
    """dq, dk, dv and the dbias plane within BWD_TOL of each output's max
    |plain|: Lq = 100 (one 128-row tile of the bf16 kernel) and Lq = Lk = L
    (2 and 5 tiles, whose dK and dV sums pass through the fp32 buffer)."""
    lq = 100 if lq_kind == "one tile" else L
    q, k, v, bias, d_out = _dense_case(card, Lq=lq, P=L - lq, bias_shape="plane")
    q, k, v, d_out = (t.to(dtype) for t in (q, k, v, d_out))
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, bias, d_out)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, bias, d_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g).all()
        _rel_close(g, w, BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", LONG)
def test_long_keys_fully_masked_row(card, dtype, L):
    """A batch row with no valid key through the stage-mask forward (chunk
    stage), the dense forward (-10000 everywhere) and the backward: finite,
    and as the plain versions."""
    (q, k, v), specs = _long_spec_case(card, L, seed=8)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    spec = specs[0]
    valid = spec.valid.clone()
    valid[1] = 0.0
    kw = dict(stage="chunk", text_len=spec.text_len)
    got = fused_attention_spec(q, k, v, valid, spec.gi, spec.rowfull, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got.float(), spec_attention_plain(q, k, v, valid, spec.gi, spec.rowfull, **kw).float(),
        rtol=0, atol=TOL[dtype])
    bias = ((1.0 - valid) * -10000.0)[:, None, None, :]
    got = fused_attention(q, k, v, bias)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), fused_attention_plain(q, k, v, bias).float(),
                               rtol=0, atol=TOL[dtype])
    d_out = torch.ones_like(q)
    for g, w in zip(flash_attention_bwd(q, k, v, bias, d_out),
                    flash_attention_bwd_plain(q, k, v, bias, d_out)):
        assert torch.isfinite(g).all()
        _close(g, w, BWD_TOL[dtype])


def test_long_keys_bf16_launches_are_bit_equal(card):
    """No atomics outside the dbias plane: two launches of each bf16 route
    at Lk = 240 agree bit for bit (the backward at Lq = 240, two tiles)."""
    (q, k, v), specs = _long_spec_case(card, 240, seed=9)
    q, k, v = _bf16(q, k, v)
    for spec in specs:
        args = (q, k, v, spec.valid, spec.gi, spec.rowfull)
        kw = dict(stage=spec.stage, text_len=spec.text_len)
        assert torch.equal(fused_attention_spec(*args, **kw), fused_attention_spec(*args, **kw))
    bias = spec_bias(specs[0].valid, specs[0].gi, specs[0].rowfull, stage="chunk",
                     text_len=specs[0].text_len, lq=q.shape[1])
    assert torch.equal(fused_attention(q, k, v, bias), fused_attention(q, k, v, bias))
    d_out = torch.randn(q.shape, device=card, generator=torch.Generator(card).manual_seed(1))
    d_out = d_out.bfloat16()
    first = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)
    second = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)
    for a, b in zip(first[:3], second[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_4000_keys_are_taken(card, dtype):
    """Far past any one block's shared memory: 4000 keys through all three
    kernels (bf16 at Dh 64; fp32 at Dh 32 for the forwards)."""
    rng = np.random.default_rng(10)
    dh = 64 if dtype == torch.bfloat16 else 32
    B, lq, lk, H = 2, 30, 4000, 2
    q, k, v, d_out = (torch.from_numpy(rng.normal(size=(B, n, H, dh)).astype(np.float32))
                      .to(card, dtype) for n in (lq, lk, lk, lq))
    valid = torch.ones(B, lk, device=card)
    valid[1, 3000:] = 0.0
    gi = torch.full((B, lk), -1, dtype=torch.int32, device=card)
    rowfull = torch.zeros(B, lk, device=card)
    kw = dict(stage="full", text_len=lq)
    torch.testing.assert_close(
        fused_attention_spec(q, k, v, valid, gi, rowfull, **kw).float(),
        spec_attention_plain(q, k, v, valid, gi, rowfull, **kw).float(),
        rtol=0, atol=TOL[dtype])
    bias = ((1.0 - valid) * -10000.0)[:, None, None, :]
    torch.testing.assert_close(fused_attention(q, k, v, bias).float(),
                               fused_attention_plain(q, k, v, bias).float(),
                               rtol=0, atol=TOL[dtype])
    for g, w in zip(flash_attention_bwd(q, k, v, bias, d_out),
                    flash_attention_bwd_plain(q, k, v, bias, d_out)):
        _close(g, w, BWD_TOL[dtype])


# ---------------------------------------------------------------- the backward
# at the rationale family's trainable encoders (32 rows: 8 questions a step)

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage_idx", [0, 1, 2], ids=["chunk", "full", "cross"])
def test_backward_at_the_encoder_shape_with_the_stage_plane(card, dtype, stage_idx):
    """The backward as the stage-mask op's gradient calls it when the
    encoders train: (32, 190, 190, 12, 64) with the stage mask as ``spec_bias`` builds it (a
    [B, 1, Lq, Lk] plane in the chunk and cross stages, a [B, 1, 1, Lk] row
    in the full stage), ragged text, chunks and regions: dq, dk, dv and the
    dbias plane within the backward's tolerance of each output's max |plain|."""
    (q, k, v), specs = _case(card, B=32, T=140, I=50, H=12, Dh=64, seed=5)
    spec = specs[stage_idx]
    bias = spec_bias(spec.valid, spec.gi, spec.rowfull, stage=spec.stage,
                     text_len=spec.text_len, lq=q.shape[1])
    assert bias.shape == ((32, 1, 1, 190) if spec.stage == "full" else (32, 1, 190, 190))
    d_out = torch.randn(q.shape, device=card, generator=torch.Generator(card).manual_seed(1))
    q, k, v, d_out = (t.to(dtype) for t in (q, k, v, d_out))
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, bias, d_out)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, bias, d_out)):
        assert g.dtype == w.dtype and torch.isfinite(g).all()
        _rel_close(g, w, BWD_TOL[dtype])


# ---------------------------------------------------------------- int8 products
# ``int8_matmul`` on the card: ``torch._int_mm`` for the codes (no kernel of
# this repo stands behind it), held to the plain float64 accumulator.

@pytest.mark.parametrize("rows,k,n", [(6080, 768, 3072), (200, 1024, 4096), (17, 64, 8)],
                         ids=["encoder-ffn", "roberta-ffn", "smallest"])
def test_int8_accumulator_and_output_bit_equal_to_plain(card, rows, k, n):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(rows, k, device=card, generator=g).to(torch.bfloat16)
    w = torch.randn(n, k, device=card, generator=g).to(torch.bfloat16)
    b = torch.randn(n, device=card, generator=g).to(torch.bfloat16)
    xq, _ = quantize_symmetric(x, 1)
    wq, _ = quantize_symmetric(w, 1)
    acc = int8_mm(xq, wq)
    assert acc.dtype == torch.int32 and torch.equal(acc, int8_mm_plain(xq, wq))
    out = int8_matmul(x, w, b, torch.bfloat16)
    assert torch.equal(out, int8_matmul(x, w, b, torch.bfloat16, plain=True))


@pytest.mark.parametrize("rows,k,n", [(16, 64, 64), (32, 60, 64), (32, 64, 60)],
                         ids=["rows", "inner", "outer"])
def test_int_mm_shape_rules_raise_on_the_card(card, rows, k, n):
    x, w = torch.randn(rows, k, device=card), torch.randn(n, k, device=card)
    with pytest.raises(ValueError, match=rf"torch._int_mm .* x \[{rows}, {k}\]"):
        int8_matmul(x, w)
