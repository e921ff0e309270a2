"""PyTorch port, attention for training: the plain versions of the dense-bias
forward and of the attention backward, the ``mem_efficient_attention``
Function and the stage-mask Function's gradients, held against the JAX
package on the same numpy inputs (fp32, atol = rtol = 2e-4).

JAX's Pallas kernels run in interpret mode, as tests/test_pallas.py and
tests/test_flash.py run them on the CPU.  JAX's stage-mask kernel has no VJP,
so the stage-mask gradients are held against ``jax.grad`` of the dense path
(``dot_product_attention`` over ``build_stage_biases``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.ops import chunk as jchunk
from multimodal_context_reasoning_tpu.ops import masks as jmasks
from multimodal_context_reasoning_tpu.ops.attention import (
    dot_product_attention as j_attention,
)
from multimodal_context_reasoning_tpu.ops.flash import (
    flash_attention_bwd_pallas as j_bwd_pallas,
    mem_efficient_attention as j_mea,
)
from multimodal_context_reasoning_tpu.ops.pallas_attention import (
    fused_attention as j_fused,
)
from multimodal_context_reasoning_torch.ops import masks as tmasks
from multimodal_context_reasoning_torch.ops.attention import (
    dot_product_attention as t_attention,
)
from multimodal_context_reasoning_torch.ops.flash import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
    mem_efficient_attention,
)
from multimodal_context_reasoning_torch.ops.fused_attention import (
    fused_attention,
    fused_attention_plain,
)
from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(B=2, Lq=9, P=4, H=3, Dh=16, seed=0):
    """q, k, v, d_out and two head-shared biases: RoBERTa's padding row
    [B, 1, 1, Lk] at -10000 and a random [B, 1, Lq, Lk] plane."""
    rng = np.random.default_rng(seed)
    Lk = P + Lq
    q = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, Lk, H, Dh)).astype(np.float32) for _ in range(2))
    d_out = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    valid = np.ones((B, Lk), np.float32)
    valid[0, Lk - 3:] = 0.0
    valid[1, P:P + 2] = 0.0
    row = ((1.0 - valid) * -10000.0)[:, None, None, :]
    plane = rng.normal(size=(B, 1, Lq, Lk)).astype(np.float32)
    return dict(q=q, k=k, v=v, d_out=d_out, row=row, plane=plane)


@pytest.fixture(scope="module")
def data():
    return _inputs()


def _bias(data, which):
    return None if which is None else data[which]


@pytest.mark.parametrize("which", ["row", "plane"])
def test_dense_plain_matches_jax_kernel(data, which):
    q, k, v, bias = data["q"], data["k"], data["v"], data[which]
    want = np.asarray(j_fused(q, k, v, bias, interpret=True))
    got = fused_attention_plain(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("which", ["row", "plane", None])
def test_plain_backward_matches_jax_kernel(data, which):
    q, k, v, d_out, bias = data["q"], data["k"], data["v"], data["d_out"], _bias(data, which)
    want = j_bwd_pallas(q, k, v, bias, d_out, interpret=True)
    got = flash_attention_bwd_plain(_t(q), _t(k), _t(v), None if bias is None else _t(bias),
                                    _t(d_out))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("which", ["plane", None])
def test_plain_backward_matches_jnp_backward(data, which):
    """The jnp recompute backward ``_mea_bwd`` (impl="jnp"); with a
    [B, 1, Lq, Lk] bias its bias gradient is the head-summed plane."""
    q, k, v, d_out, bias = data["q"], data["k"], data["v"], data["d_out"], _bias(data, which)
    args = (q, k, v) + ((bias,) if bias is not None else ())

    def f(*a):
        return j_mea(*a[:3], a[3] if len(a) > 3 else None, impl="jnp")

    _, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(d_out))
    got = flash_attention_bwd_plain(_t(q), _t(k), _t(v), None if bias is None else _t(bias),
                                    _t(d_out))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if bias is not None:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3])[:, 0], **TOL)


@pytest.mark.parametrize("which", ["row", "plane"])
def test_mem_efficient_attention_grads_match_jax(data, which):
    """Gradients in q, k, v and the bias (reduced to the bias's own shape,
    the padding row included) against jax.grad through the Pallas backward."""
    q, k, v, d_out, bias = data["q"], data["k"], data["v"], data["d_out"], data[which]

    def loss(q, k, v, b):
        return jnp.sum(j_mea(q, k, v, b, impl="pallas") * d_out)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, bias)
    leaves = [_t(x).requires_grad_() for x in (q, k, v, bias)]
    out = mem_efficient_attention(*leaves)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(j_mea(q, k, v, bias)), **TOL)
    (out * _t(d_out)).sum().backward()
    for leaf, w in zip(leaves, want):
        assert leaf.grad.shape == leaf.shape
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **TOL)


def _spec_geometry(B=2, T=13, I=6, H=3, Dh=16, seed=1):
    rng = np.random.default_rng(seed)
    text_mask = np.ones((B, T), np.float32)
    text_mask[1, T - 4:] = 0.0
    img_mask = np.ones((B, I), np.float32)
    img_mask[0, I - 2:] = 0.0
    gi = np.full((B, T), -1, np.int32)
    for t in range(1, T - 3, 2):
        gi[:, t] = gi[:, t + 1] = (t - 1) // 2
    gi[1, T - 4:] = -1
    L = T + I
    q, k, v, d_out = (rng.normal(size=(B, L, H, Dh)).astype(np.float32) for _ in range(4))
    return text_mask, img_mask, gi, q, k, v, d_out


def _jax_dense_grads(q, k, v, bias, d_out):
    def loss(q, k, v):
        return jnp.sum(j_attention(q, k, v, bias)[0] * d_out)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _spec_grads(q, k, v, vecs, d_out, **kw):
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    (fused_attention_spec(*leaves, *vecs, **kw) * _t(d_out)).sum().backward()
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("stage_idx,stage", [(0, "chunk"), (1, "full"), (2, "cross")])
def test_spec_function_grads_match_jax_dense_path(stage_idx, stage):
    text_mask, img_mask, gi, q, k, v, d_out = _spec_geometry()
    cm = jchunk.chunk_mask_from_gather_index(jnp.asarray(gi), jnp.asarray(text_mask))
    bias = jmasks.build_stage_biases(jnp.asarray(text_mask), jnp.asarray(img_mask),
                                     cm)[stage_idx]
    want = _jax_dense_grads(q, k, v, bias, d_out)
    spec = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))[stage_idx]
    got = _spec_grads(q, k, v, (spec.valid, spec.gi, spec.rowfull), d_out,
                      stage=stage, text_len=spec.text_len)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_spec_function_prefixed_full_stage_grads_match_jax():
    """RoBERTa's geometry: Lk = P + Lq, validity over the prefixed stream."""
    d = _inputs(seed=3)
    B, Lk = d["k"].shape[:2]
    valid = np.ones((B, Lk), np.float32)
    valid[0, Lk - 3:] = 0.0
    valid[1, 1:3] = 0.0
    want = _jax_dense_grads(d["q"], d["k"], d["v"], jmasks.padding_bias(jnp.asarray(valid)),
                            d["d_out"])
    spec = tmasks.full_mask_spec(_t(valid), d["q"].shape[1])
    got = _spec_grads(d["q"], d["k"], d["v"], (spec.valid, spec.gi, spec.rowfull),
                      d["d_out"], stage="full", text_len=spec.text_len)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _saved_shapes(fn):
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return shapes


def test_no_quadratic_residual_is_saved(data):
    """Neither Function keeps a [B, H, Lq, Lk] tensor for its backward; the
    plain attention does, which shows the hook sees what it should."""
    q, k, v, bias = (_t(data[n]).requires_grad_() for n in ("q", "k", "v", "plane"))
    B, lq, H = q.shape[:3]
    lk = k.shape[1]
    quad = (B, H, lq, lk)
    assert quad not in _saved_shapes(lambda: mem_efficient_attention(q, k, v, bias))
    spec = tmasks.full_mask_spec(torch.ones(B, lk), lq)
    assert quad not in _saved_shapes(lambda: fused_attention_spec(
        q, k, v, spec.valid, spec.gi, spec.rowfull, stage="full", text_len=lq))
    assert quad in _saved_shapes(lambda: t_attention(q, k, v, bias))


def test_cpu_wrappers_take_plain_versions_without_counting(data):
    q, k, v, d_out, bias = (_t(data[n]) for n in ("q", "k", "v", "d_out", "row"))
    before = (fused_attention.launches, flash_attention_bwd.launches)
    assert torch.equal(fused_attention(q, k, v, bias), fused_attention_plain(q, k, v, bias))
    got = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)
    want = flash_attention_bwd_plain(q, k, v, bias, d_out)
    assert got[3] is None
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert (fused_attention.launches, flash_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention.launch(q, k, v, bias)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd.launch(q, k, v, bias, d_out)


def test_plain_backward_matches_jax_kernel_in_bf16():
    """bf16 inputs at a ragged shape (Lq = 13, Lk = 19): the plain backward,
    the card kernel's oracle, takes the Pallas kernel's order of casts (P
    rounded before dV, dS / sqrt(Dh) rounded before dQ and dK).  Both sides
    round the same fp32 values, so dq, dk and dv may differ only where the
    fp32 summation order tips a rounding: at least 99% of elements bit-equal
    and none off by more than one bf16 step (2^-7 of the value).  Leaving
    out either rounding puts about 40% of elements off by tens of steps.
    The dbias plane is fp32: 1e-5."""
    rng = np.random.default_rng(5)
    B, Lq, Lk, H, Dh = 2, 13, 19, 3, 64
    q, d_out = (rng.normal(size=(B, Lq, H, Dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, Lk, H, Dh)).astype(np.float32) for _ in range(2))
    bias = rng.normal(size=(B, 1, Lq, Lk)).astype(np.float32)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, d_out)]
    want = j_bwd_pallas(bf[0], bf[1], bf[2], jnp.asarray(bias), bf[3], interpret=True)
    tb = [_t(x).bfloat16() for x in (q, k, v, d_out)]
    got = flash_attention_bwd_plain(tb[0], tb[1], tb[2], _t(bias), tb[3])
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert g.dtype == torch.bfloat16, name
        w = torch.from_numpy(np.asarray(w.astype(jnp.float32)))
        diff = (g.float() - w).abs()
        assert (diff == 0).float().mean().item() >= 0.99, name
        assert bool((diff <= 2.0 ** -7 * w.abs()).all()), name
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-5, atol=1e-5)
