"""PyTorch port, every head dim the Pallas kernels take: the plain versions
of the three kernels (the card kernels' oracles) against the Pallas kernels
in interpret mode, as tests/test_pallas.py and tests/test_flash.py run them
on the CPU, at head dims 8 to 128 in fp32 and bf16, 160 to 1024 in fp32
(past 256 the FP32-pipe kernels run in slabs) and 160 to 512 in bf16 (past
128 the tensor-core kernels run in slabs of 128); the zero padding the bf16
launchers apply to reach a tensor-core width
(``ops/fused_attention.py::pad_bf16_heads``) against the unpadded function;
that no head width stops a launcher before its device check; and tiny
models against the JAX package on the same weights: in bf16 at heads of 8
and 12 and at heads of 192 and 256, in fp32 at heads of 320 and 512.

Tolerances: fp32 1e-5 (abs and rel; only the summation order differs);
bf16 the bound of tests/test_torch_flash.py for the dense-bias forward and
the backward (99% of elements bit-equal, none more than one bf16 step
apart; dbias 1e-5) and of tests/test_torch_ops.py for the stage-mask
forward (1e-2 abs and rel).  The padded functions lie within 1e-6 of max
|plain| of the unpadded ones in fp32.  The bf16 models: logits and losses
within 1e-2, the gradient norm within 2e-2 relative; the fp32 model:
logits and loss within 2e-4 (tests/test_torch_models.py), loss and
gradient norm within rtol 1e-4, atol 1e-5 (tests/test_torch_train.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.ops import masks as jmasks
from multimodal_context_reasoning_tpu.ops.flash import (
    flash_attention_bwd_pallas as j_bwd_pallas,
)
from multimodal_context_reasoning_tpu.ops.pallas_attention import (
    fused_attention as j_fused,
    fused_attention_spec as j_spec,
)
from multimodal_context_reasoning_tpu.train import optim as joptim
from multimodal_context_reasoning_tpu.train.state import TrainState as JState
from multimodal_context_reasoning_tpu.train.step import make_train_step
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.core.config import TrainConfig
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.ops import masks as tmasks
from multimodal_context_reasoning_torch.ops.flash import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from multimodal_context_reasoning_torch.ops.fused_attention import (
    BF16_HEAD_DIMS,
    SLAB_DH,
    bf16_width,
    fused_attention,
    fused_attention_plain,
    pad_bf16_heads,
    unpad_heads,
)
from multimodal_context_reasoning_torch.ops.spec_attention import (
    fused_attention_spec,
    spec_attention_plain,
)
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.train.step import train_step
from tests.test_torch_models import make_batch

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_SPEC_TOL = dict(rtol=1e-2, atol=1e-2)
PAD_TOL = 1e-6          # of max |plain|
DIMS = (8, 12, 16, 32, 48, 80, 96, 128)
# past the widest instance: fp32 above 256 and bf16 above 128 run in slabs
CASES = ([("float32", dh) for dh in DIMS + (160, 256, 288, 320, 512, 1024)]
         + [("bfloat16", dh) for dh in DIMS + (160, 192, 256, 384, 512)])
IDS = [f"{dt}-{dh}" for dt, dh in CASES]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side is small: one intra-op thread keeps it off the cores
    the other test workers use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _dense_inputs(dh, B=2, Lq=9, P=4, H=2, seed=0):
    """q, k, v, dO at head dim ``dh`` and a [B, 1, Lq, Lk] bias plane with
    RoBERTa's padding added (-10000 on three keys of row 0)."""
    rng = np.random.default_rng(seed + dh)
    Lk = P + Lq
    q, d_out = (rng.normal(size=(B, Lq, H, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, Lk, H, dh)).astype(np.float32) for _ in range(2))
    bias = rng.normal(size=(B, 1, Lq, Lk)).astype(np.float32)
    bias[0, ..., Lk - 3:] -= 10000.0
    return q, k, v, d_out, bias


def _spec_inputs(dh, B=2, T=11, I=5, H=2, seed=1):
    """Ragged text and regions, two-token chunks, q, k, v at ``dh``."""
    rng = np.random.default_rng(seed + dh)
    text_mask = np.ones((B, T), np.float32)
    text_mask[1, T - 3:] = 0.0
    img_mask = np.ones((B, I), np.float32)
    img_mask[0, I - 2:] = 0.0
    gi = np.full((B, T), -1, np.int32)
    for t in range(1, T - 3, 2):
        gi[:, t] = gi[:, t + 1] = (t - 1) // 2
    q, k, v = (rng.normal(size=(B, T + I, H, dh)).astype(np.float32) for _ in range(3))
    return text_mask, img_mask, gi, q, k, v


def _bf16_steps_apart(got, want):
    """At least 99% of bf16 elements equal and none off by more than one
    bf16 step (2^-7 of the value), as tests/test_torch_flash.py holds the
    bf16 plain versions to the Pallas kernels."""
    w = _t(np.asarray(want).astype(np.float32))
    diff = (got.float() - w).abs()
    assert (diff == 0).float().mean().item() >= 0.99
    assert bool((diff <= 2.0 ** -7 * w.abs()).all())


def _as(dtype, *xs):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return [jnp.asarray(x, jdt) for x in xs], [_t(x).to(tdt) for x in xs]


# ---------------------------------------------------------------- plain
# versions against the Pallas kernels in interpret mode

@pytest.mark.parametrize("dtype,dh", CASES, ids=IDS)
def test_dense_plain_matches_pallas(dtype, dh):
    q, k, v, _, bias = _dense_inputs(dh)
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, k, v)
    want = j_fused(jq, jk, jv, jnp.asarray(bias), interpret=True)
    got = fused_attention_plain(tq, tk, tv, _t(bias))
    assert tuple(got.shape) == q.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    else:
        assert got.dtype == torch.bfloat16
        _bf16_steps_apart(got, want)


@pytest.mark.parametrize("dtype,dh", CASES, ids=IDS)
def test_spec_plain_matches_pallas(dtype, dh):
    """The chunk stage, whose mask has every term of the algebra."""
    text_mask, img_mask, gi, q, k, v = _spec_inputs(dh)
    jspec = jmasks.stage_mask_specs(jnp.asarray(text_mask), jnp.asarray(img_mask),
                                    jnp.asarray(gi))[0]
    tspec = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))[0]
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, k, v)
    want = np.asarray(j_spec(jq, jk, jv, jspec.valid, jspec.gi, jspec.rowfull,
                             stage="chunk", text_len=jspec.text_len,
                             interpret=True).astype(jnp.float32))
    got = spec_attention_plain(tq, tk, tv, tspec.valid, tspec.gi, tspec.rowfull,
                               stage="chunk", text_len=tspec.text_len)
    assert got.dtype == tq.dtype and tuple(got.shape) == q.shape
    tol = FP32_TOL if dtype == "float32" else BF16_SPEC_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype,dh", CASES, ids=IDS)
def test_backward_plain_matches_pallas(dtype, dh):
    q, k, v, d_out, bias = _dense_inputs(dh, seed=2)
    (jq, jk, jv, jd), (tq, tk, tv, td) = _as(dtype, q, k, v, d_out)
    want = j_bwd_pallas(jq, jk, jv, jnp.asarray(bias), jd, interpret=True)
    got = flash_attention_bwd_plain(tq, tk, tv, _t(bias), td)
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == tq.dtype, name
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32_TOL, err_msg=name)
        else:
            _bf16_steps_apart(g, w)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **FP32_TOL)


# ---------------------------------------------------------------- the zero
# padding of the bf16 launchers

PAD_DIMS = (8, 12, 16, 32, 48, 64, 80, 96, 128, 160, 192, 256, 320)


def _rel(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("dh", PAD_DIMS)
def test_padding_keeps_the_buffers_and_widths(dh):
    """A head below 64 goes to the 64-wide instance, one in (64, 128] to
    the 128-wide one, a wider one to the next multiple of 128 (the slab
    instances); 64, 128 and 256 are handed over as they are; the padding
    is zeros in fresh contiguous buffers, and unpad_heads slices back."""
    q, k, v, d_out, _ = (_t(x).bfloat16() for x in _dense_inputs(dh))
    padded = pad_bf16_heads("test", q, k, v, d_out)
    width = 64 if dh <= 64 else 128 if dh <= 128 else -(-dh // 128) * 128
    assert width == bf16_width(dh)
    assert width in BF16_HEAD_DIMS or (width > 128 and width % SLAB_DH == 0)
    for t, p in zip((q, k, v, d_out), padded):
        assert p.shape[-1] == width and p.dtype == torch.bfloat16
        if width == dh:
            assert p is t
        else:
            assert p.is_contiguous() and p.data_ptr() % 16 == 0
            assert torch.equal(p[..., :dh], t) and not p[..., dh:].any()
            back = unpad_heads(p, dh)
            assert back.is_contiguous() and torch.equal(back, t)


@pytest.mark.parametrize("dh", PAD_DIMS)
def test_padded_dense_forward_and_backward_equal_unpadded(dh):
    """plain(zero-padded, scale = 1/sqrt(true Dh)), sliced, against plain at
    the true width: out, dq, dk, dv and the dbias plane, fp32."""
    q, k, v, d_out, bias = (_t(x) for x in _dense_inputs(dh, seed=3))
    pq, pk, pv, pd = pad_bf16_heads("test", q, k, v, d_out)
    scale = 1.0 / dh ** 0.5
    want = fused_attention_plain(q, k, v, bias)
    got = unpad_heads(fused_attention_plain(pq, pk, pv, bias, scale=scale), dh)
    assert _rel(got, want) <= PAD_TOL
    want = flash_attention_bwd_plain(q, k, v, bias, d_out)
    got = flash_attention_bwd_plain(pq, pk, pv, bias, pd, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        g = unpad_heads(g, dh) if name != "dbias" else g
        assert g.shape == w.shape and _rel(g, w) <= PAD_TOL, name


@pytest.mark.parametrize("stage_idx", [0, 1, 2], ids=["chunk", "full", "cross"])
@pytest.mark.parametrize("dh", PAD_DIMS)
def test_padded_spec_forward_equals_unpadded(dh, stage_idx):
    text_mask, img_mask, gi, q, k, v = _spec_inputs(dh, seed=4)
    spec = tmasks.stage_mask_specs(_t(text_mask), _t(img_mask), _t(gi))[stage_idx]
    q, k, v = _t(q), _t(k), _t(v)
    vecs = (spec.valid, spec.gi, spec.rowfull)
    kw = dict(stage=spec.stage, text_len=spec.text_len)
    pq, pk, pv = pad_bf16_heads("test", q, k, v)
    want = spec_attention_plain(q, k, v, *vecs, **kw)
    got = unpad_heads(spec_attention_plain(pq, pk, pv, *vecs, **kw, scale=1.0 / dh ** 0.5),
                      dh)
    assert _rel(got, want) <= PAD_TOL


# ---------------------------------------------------------------- no head
# width stops a launcher before its device check

@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 8), (torch.bfloat16, 96),
                                      (torch.bfloat16, 128), (torch.float32, 256),
                                      (torch.bfloat16, 160), (torch.bfloat16, 512),
                                      (torch.bfloat16, 1024), (torch.float32, 288),
                                      (torch.float32, 1024)])
def test_launchers_take_every_head_up_to_the_limit(dtype, dh):
    """Every head width passes the launchers' checks (the kernels take any
    width, in slabs past their widest instance): on CPU tensors each
    launcher stops only at the device check, and nothing is launched."""
    q = torch.zeros(1, 4, 2, dh, dtype=dtype)
    vecs = (torch.ones(1, 4), torch.full((1, 4), -1, dtype=torch.int32), torch.zeros(1, 4))
    before = (fused_attention.launches, fused_attention_spec.launches,
              flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_attention.launch(q, q, q, None)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_attention_spec.launch(q, q, q, *vecs, stage="full", text_len=4)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bwd.launch(q, q, q, None, torch.zeros_like(q))
    assert (fused_attention.launches, fused_attention_spec.launches,
            flash_attention_bwd.launches) == before


# ---------------------------------------------------------------- the bf16
# tiny model (heads of 8 and 12) against JAX

def _tiny_bf16(cls):
    """ModCRConfig.tiny() in bf16, mapping dropout 0 (JAX's and torch's
    dropout streams differ); every other dropout of tiny is 0 already."""
    return dataclasses.replace(cls.tiny().with_dtype("bfloat16"), mapping_dropout=0.0)


def _jax_reference(jcfg, tcfg, *, jit_apply=False):
    """The JAX model's logits and loss, and the metrics of one train step
    from its seeded initial weights, with those weights carried across.
    ``jit_apply`` compiles the forward (in fp32 within 5e-7 of the eager
    one, and about 30 s sooner on this CPU; in bf16 XLA's fusions round
    otherwise, so the bf16 references stay eager)."""
    batch = make_batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JModel(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jbatch)
    out = (jax.jit(model.apply) if jit_apply else model.apply)(params, jbatch)
    tx = joptim.make_optimizer(JTrainConfig(learning_rate=1e-3), 10, params)
    step = make_train_step(model, donate=False)
    _, metrics = step(JState.create(params, tx), jbatch, jax.random.PRNGKey(1))
    return dict(tcfg=tcfg, batch={k: _t(v) for k, v in batch.items()},
                sd=params_from_jax(jax.tree.map(np.asarray, params), tcfg),
                logits=np.asarray(out.logits.astype(jnp.float32)), loss=float(out.loss),
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def tiny_bf16():
    jcfg, tcfg = _tiny_bf16(JConfig), _tiny_bf16(TConfig)
    assert (tcfg.global_encoder.head_dim, tcfg.roberta.head_dim) == (8, 12)
    return _jax_reference(jcfg, tcfg)


def test_bf16_tiny_forward_matches_jax(tiny_bf16):
    """Logits and loss of one deterministic forward within 1e-2 (logits
    about 1 in size, where one bf16 step is 2^-7 to 2^-8: XLA and torch
    round their bf16 products in their own order; measured 3.9e-3 and
    2.4e-3 on this batch)."""
    model = TModel(tiny_bf16["tcfg"], device="cpu")
    model.load_state_dict(tiny_bf16["sd"], strict=True)
    with torch.no_grad():
        out = model.eval()(tiny_bf16["batch"])
    np.testing.assert_allclose(out.logits.float().numpy(), tiny_bf16["logits"],
                               rtol=0, atol=1e-2)
    np.testing.assert_allclose(float(out.loss), tiny_bf16["loss"], rtol=0, atol=1e-2)


def test_bf16_tiny_train_step_matches_jax(tiny_bf16):
    """One train step from the same weights: loss within 1e-2 and the
    gradient norm within 2e-2 relative (bf16 products, as above; measured
    3.4e-3 and 5.8e-3)."""
    model = TModel(tiny_bf16["tcfg"], device="cpu")
    model.load_state_dict(tiny_bf16["sd"], strict=True)
    state = TrainState.create(model, TrainConfig(learning_rate=1e-3), 10)
    got = {k: float(v) for k, v in train_step(state, tiny_bf16["batch"]).items()}
    want = tiny_bf16["metrics"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-2)
    assert got["count"] == want["count"] and state.step == 1
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---------------------------------------------------------------- tiny
# models with heads wider than the widest instance (one head a layer)

WIDE = {"bfloat16-192-256": ("bfloat16", 192, 256), "float32-320-512": ("float32", 320, 512)}


def _tiny_wide(cls, dtype, enc_dh, rob_dh):
    """ModCRConfig.tiny() with one attention head a layer, ``enc_dh`` wide in
    both encoders and ``rob_dh`` in RoBERTa, mapping dropout 0, and cut to
    one layer of each encoder stage (chunk, full, cross) and one RoBERTa
    layer."""
    tiny = cls.tiny()
    enc = dataclasses.replace(tiny.global_encoder, hidden_size=enc_dh, num_attention_heads=1,
                              intermediate_size=2 * enc_dh, num_hidden_layers=3)
    rob = dataclasses.replace(tiny.roberta, hidden_size=rob_dh, num_attention_heads=1,
                              intermediate_size=2 * rob_dh, num_hidden_layers=1)
    cfg = dataclasses.replace(tiny, global_encoder=enc, seq_encoder=enc, roberta=rob,
                              mapping_dropout=0.0)
    return cfg.with_dtype(dtype)


@pytest.fixture(scope="module", params=list(WIDE), ids=list(WIDE))
def tiny_wide(request):
    dtype, enc_dh, rob_dh = WIDE[request.param]
    tcfg = _tiny_wide(TConfig, dtype, enc_dh, rob_dh)
    assert (tcfg.global_encoder.head_dim, tcfg.roberta.head_dim) == (enc_dh, rob_dh)
    jcfg = _tiny_wide(JConfig, dtype, enc_dh, rob_dh)
    return dict(_jax_reference(jcfg, tcfg, jit_apply=dtype == "float32"), dtype=dtype)


def test_wide_heads_tiny_forward_matches_jax(tiny_wide):
    """Logits and loss of one deterministic forward: bf16 (heads of 192
    and 256) within 1e-2 abs, as the bf16 tiny model (measured 3.9e-3 in
    the logits, up to 0.77 in size: one bf16 step, and 2.8e-3 in the
    loss); fp32 (heads of 320 and 512) within 2e-4 abs and rel (measured
    8.9e-7)."""
    model = TModel(tiny_wide["tcfg"], device="cpu")
    model.load_state_dict(tiny_wide["sd"], strict=True)
    with torch.no_grad():
        out = model.eval()(tiny_wide["batch"])
    tol = (dict(rtol=0, atol=1e-2) if tiny_wide["dtype"] == "bfloat16"
           else dict(rtol=2e-4, atol=2e-4))
    np.testing.assert_allclose(out.logits.float().numpy(), tiny_wide["logits"], **tol)
    np.testing.assert_allclose(float(out.loss), tiny_wide["loss"], **tol)


def test_wide_heads_tiny_train_step_matches_jax(tiny_wide):
    """One train step from the same weights: bf16 as the bf16 tiny model
    (loss within 1e-2, gradient norm within 2e-2 relative; measured 4.3e-3
    and 4.0e-4); fp32 loss and gradient norm within rtol 1e-4, atol 1e-5
    (measured 0 and 2.4e-7 relative)."""
    model = TModel(tiny_wide["tcfg"], device="cpu")
    model.load_state_dict(tiny_wide["sd"], strict=True)
    state = TrainState.create(model, TrainConfig(learning_rate=1e-3), 10)
    got = {k: float(v) for k, v in train_step(state, tiny_wide["batch"]).items()}
    want = tiny_wide["metrics"]
    if tiny_wide["dtype"] == "bfloat16":
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-2)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-2)
    else:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)
    assert got["count"] == want["count"] and state.step == 1
