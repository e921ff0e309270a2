"""PyTorch port, ops layer: the stage-mask attention's plain version, the
mask program, the chunk ops and the plain attention, held against the JAX
package on the same numpy inputs (fp32, atol = rtol = 2e-4 where the
arithmetic order may differ, bit-equal where it does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.ops import chunk as jchunk
from multimodal_context_reasoning_tpu.ops import masks as jmasks
from multimodal_context_reasoning_tpu.ops.attention import (
    dot_product_attention as j_attention,
)
from multimodal_context_reasoning_tpu.ops.pallas_attention import (
    fused_attention_spec as j_spec,
)
from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.ops import build as tbuild
from multimodal_context_reasoning_torch.ops import chunk as tchunk
from multimodal_context_reasoning_torch.ops import masks as tmasks
from multimodal_context_reasoning_torch.ops.attention import (
    dot_product_attention as t_attention,
)
from multimodal_context_reasoning_torch.ops.fused_attention import fused_attention_plain
from multimodal_context_reasoning_torch.ops.spec_attention import (
    fused_attention_spec,
    spec_attention_plain,
    spec_bias,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _geometry(B=2, T=21, I=9, H=4, Dh=32, seed=0):
    """tests/test_pallas.py TestSpecKernel geometry: ragged text and
    regions, two-token chunks, nothing chunked in padding."""
    rng = np.random.default_rng(seed)
    L = T + I
    text_mask = np.ones((B, T), np.float32)
    text_mask[1, T - 4:] = 0.0
    img_mask = np.ones((B, I), np.float32)
    img_mask[0, I - 2:] = 0.0
    gi = np.full((B, T), -1, np.int32)
    for t in range(1, T - 3, 2):
        gi[:, t] = (t - 1) // 2
        gi[:, t + 1] = (t - 1) // 2
    gi[1, T - 4:] = -1
    q, k, v = (rng.normal(size=(B, L, H, Dh)).astype(np.float32) for _ in range(3))
    return text_mask, img_mask, gi, q, k, v


@pytest.fixture(scope="module")
def geometry():
    return _geometry()


@pytest.mark.parametrize("stage_idx,stage", [(0, "chunk"), (1, "full"), (2, "cross")])
def test_spec_plain_matches_jax_kernel(geometry, stage_idx, stage):
    text_mask, img_mask, gi, q, k, v = geometry
    jspec = jmasks.stage_mask_specs(jnp.asarray(text_mask), jnp.asarray(img_mask),
                                    jnp.asarray(gi))[stage_idx]
    tspec = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))[stage_idx]
    assert jspec.stage == tspec.stage == stage
    want = j_spec(q, k, v, jspec.valid, jspec.gi, jspec.rowfull, stage=stage,
                  text_len=jspec.text_len, interpret=True)
    got = fused_attention_spec(_t(q), _t(k), _t(v), tspec.valid, tspec.gi,
                               tspec.rowfull, stage=stage, text_len=tspec.text_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spec_plain_prefixed_full_stage_matches_jax():
    """RoBERTa path: Lk = P + Lq, validity over the prefixed stream."""
    rng = np.random.default_rng(3)
    B, Lq, P, H, Dh = 2, 19, 10, 2, 32
    Lk = P + Lq
    q = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, Lk, H, Dh)).astype(np.float32) for _ in range(2))
    valid = np.ones((B, Lk), np.float32)
    valid[0, Lk - 3:] = 0.0
    valid[1, 2:4] = 0.0
    gi = np.full((B, Lk), -1, np.int32)
    rowfull = np.zeros((B, Lk), np.float32)
    want = j_spec(q, k, v, valid, gi, rowfull, stage="full", text_len=Lq,
                  interpret=True)
    got = spec_attention_plain(_t(q), _t(k), _t(v), _t(valid), _t(gi), _t(rowfull),
                               stage="full", text_len=Lq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stage", ["chunk", "full", "cross"])
def test_spec_plain_fully_masked_rows_match_jax(geometry, stage):
    """No visible key: both give a finite (uniform) row, the same one."""
    text_mask, img_mask, gi, q, k, v = geometry
    valid = np.zeros((q.shape[0], q.shape[1]), np.float32)
    full_gi = np.concatenate([gi, np.full((gi.shape[0], img_mask.shape[1]), -1,
                                          np.int32)], axis=1)
    rowfull = np.zeros_like(valid)
    T = text_mask.shape[1]
    want = np.asarray(j_spec(q, k, v, valid, full_gi, rowfull, stage=stage,
                             text_len=T, interpret=True))
    got = spec_attention_plain(_t(q), _t(k), _t(v), _t(valid), _t(full_gi),
                               _t(rowfull), stage=stage, text_len=T).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_spec_plain_bf16_rounds_p_like_jax(geometry):
    """bf16 inputs: fp32 scores and softmax, P rounded to bf16 before PV."""
    text_mask, img_mask, gi, q, k, v = geometry
    jspec = jmasks.stage_mask_specs(jnp.asarray(text_mask), jnp.asarray(img_mask),
                                    jnp.asarray(gi))[0]
    tspec = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))[0]
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(j_spec(qb, kb, vb, jspec.valid, jspec.gi, jspec.rowfull,
                             stage="chunk", text_len=jspec.text_len,
                             interpret=True).astype(jnp.float32))
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = spec_attention_plain(tq, tk, tv, tspec.valid, tspec.gi, tspec.rowfull,
                               stage="chunk", text_len=tspec.text_len)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the output's magnitude: the rounding of out itself
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_wrapper_takes_plain_version_on_cpu_without_counting(geometry):
    text_mask, img_mask, gi, q, k, v = geometry
    spec = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))[2]
    before = fused_attention_spec.launches
    a = fused_attention_spec(_t(q), _t(k), _t(v), spec.valid, spec.gi, spec.rowfull,
                             stage="cross", text_len=spec.text_len)
    b = spec_attention_plain(_t(q), _t(k), _t(v), spec.valid, spec.gi, spec.rowfull,
                             stage="cross", text_len=spec.text_len)
    assert fused_attention_spec.launches == before
    assert torch.equal(a, b)


def test_wrapper_records_its_function_only_when_a_gradient_is_needed(geometry):
    """q, k or v needing a gradient goes through the autograd Function (whose
    backward is the backward kernel's); otherwise the forward alone runs, with
    the same output."""
    text_mask, img_mask, gi, q, k, v = geometry
    spec = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))[0]
    vec = (spec.valid, spec.gi, spec.rowfull)
    kw = dict(stage="chunk", text_len=spec.text_len)
    plain = fused_attention_spec(_t(q), _t(k), _t(v), *vec, **kw)
    assert plain.grad_fn is None
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        assert fused_attention_spec(*leaves, *vec, **kw).grad_fn is None
    out = fused_attention_spec(*leaves, *vec, **kw)
    assert type(out.grad_fn).__name__ == "_SpecAttentionFnBackward"
    assert torch.equal(out.detach(), plain)


def test_launch_refuses_cpu_tensors_and_bad_stages(geometry):
    text_mask, img_mask, gi, q, k, v = geometry
    spec = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))[1]
    args = (_t(q), _t(k), _t(v), spec.valid, spec.gi, spec.rowfull)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention_spec.launch(*args, stage="full", text_len=spec.text_len)
    with pytest.raises(ValueError, match="stage"):
        fused_attention_spec.launch(*args, stage="diagonal", text_len=spec.text_len)
    with pytest.raises(ValueError, match="Lq"):
        fused_attention_spec.launch(_t(q[:, :5]), *args[1:], stage="chunk",
                                    text_len=spec.text_len)


def test_stage_biases_bit_equal(geometry):
    text_mask, img_mask, gi, *_ = geometry
    jcm = jchunk.chunk_mask_from_gather_index(jnp.asarray(gi), jnp.asarray(text_mask))
    tcm = tchunk.chunk_mask_from_gather_index(_t(gi), _t(text_mask))
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    want = jmasks.build_stage_biases(jnp.asarray(text_mask), jnp.asarray(img_mask), jcm)
    got = tmasks.build_stage_biases(_t(text_mask), _t(img_mask), tcm)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tmasks.padding_bias(_t(text_mask)).numpy(),
        np.asarray(jmasks.padding_bias(jnp.asarray(text_mask))))


def test_stage_mask_specs_bit_equal(geometry):
    text_mask, img_mask, gi, *_ = geometry
    want = jmasks.stage_mask_specs(jnp.asarray(text_mask), jnp.asarray(img_mask),
                                   jnp.asarray(gi))
    got = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))
    for g, w in zip(got, want):
        assert (g.stage, g.text_len) == (w.stage, w.text_len)
        for name in ("valid", "gi", "rowfull"):
            gv, wv = getattr(g, name).numpy(), np.asarray(getattr(w, name))
            assert gv.dtype == wv.dtype, name
            np.testing.assert_array_equal(gv, wv)


def test_chunk_mean_scatter_bit_equal(geometry):
    text_mask, img_mask, gi, q, *_ = geometry
    x = q.reshape(q.shape[0], q.shape[1], -1)[:, : gi.shape[1]]
    want = np.asarray(jchunk.chunk_mean_scatter(jnp.asarray(x), jnp.asarray(gi), 12))
    got = tchunk.chunk_mean_scatter(_t(x), _t(gi), 12).numpy()
    np.testing.assert_array_equal(got, want)


def test_dot_product_attention_matches_jax(geometry):
    text_mask, img_mask, gi, q, k, v = geometry
    jcm = jchunk.chunk_mask_from_gather_index(jnp.asarray(gi), jnp.asarray(text_mask))
    bias = np.asarray(jmasks.build_stage_biases(
        jnp.asarray(text_mask), jnp.asarray(img_mask), jcm)[0])
    want_out, want_p = j_attention(q, k, v, bias, return_probs=True)
    got_out, got_p = t_attention(_t(q), _t(k), _t(v), _t(bias), return_probs=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


def _tiny_ragged_case(dtype, seed=5):
    """``ModCRConfig.tiny()``'s encoder geometry (16 text + 8 regions, 4
    heads of 8), ragged text, regions and chunks, and a third batch row with
    no real token, whose every query row is fully masked in the full and
    chunk stages (and every text row in the cross stage)."""
    cfg = ModCRConfig.tiny()
    enc = cfg.seq_encoder
    T, I, H = cfg.text_len, cfg.img_len, enc.num_attention_heads
    Dh = enc.hidden_size // H
    text_mask, img_mask, gi, q, k, v = _geometry(B=3, T=T, I=I, H=H, Dh=Dh, seed=seed)
    text_mask[2], img_mask[2], gi[2] = 0.0, 0.0, -1
    specs = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))
    return specs, [_t(x).to(dtype) for x in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage_idx,stage", [(0, "chunk"), (1, "full"), (2, "cross")])
def test_spec_bias_through_dense_plain_is_spec_plain_bit_for_bit(dtype, stage_idx, stage):
    """The stage-mask kernel adds -((1 - vis) * 1e9) where the plain version
    subtracts (1 - vis) * 1e9: x + (-n) rounds as x - n does, so the dense
    forward's plain version with :func:`spec_bias` gives the same bits."""
    specs, (q, k, v) = _tiny_ragged_case(dtype)
    spec = specs[stage_idx]
    assert spec.stage == stage
    vec = (spec.valid, spec.gi, spec.rowfull)
    bias = spec_bias(*vec, stage=stage, text_len=spec.text_len, lq=q.shape[1])
    got = fused_attention_plain(q, k, v, bias)
    want = spec_attention_plain(q, k, v, *vec, stage=stage, text_len=spec.text_len)
    assert got.dtype == want.dtype == dtype
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)
    # the fully masked rows come out uniform: the mean of v over all keys
    masked = want[2].float()
    if stage != "cross":
        mean_v = v[2].float().mean(dim=0, keepdim=True).to(dtype).float()
        torch.testing.assert_close(masked, mean_v.expand_as(masked), rtol=0, atol=1e-2)


def test_rebuild_key_covers_every_header(tmp_path, monkeypatch):
    """An edit to any ``csrc/*.cuh`` changes the rebuild key of every kernel
    source, so a stale library is never loaded; an unrelated file does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in tbuild.CSRC_DIR.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    assert {p.name for p in csrc.glob("*.cuh")} >= {"common.cuh", "attention_mma.cuh"}
    monkeypatch.setattr(tbuild, "CSRC_DIR", csrc)
    names = ("spec_attention", "fused_attention", "flash_bwd")
    before = {n: tbuild.source_digest(csrc / f"{n}.cu") for n in names}
    assert len(set(before.values())) == len(names)
    (csrc / "notes.txt").write_text("not a header")
    assert {n: tbuild.source_digest(csrc / f"{n}.cu") for n in names} == before
    for header in ("attention_mma.cuh", "common.cuh"):
        path = csrc / header
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
        after = {n: tbuild.source_digest(csrc / f"{n}.cu") for n in names}
        assert all(after[n] != before[n] for n in names), header
        before = after
