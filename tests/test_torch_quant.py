"""PyTorch port, W8A8 int8 inference: ``ops/quant.py``, the int8 route of
``models/layers.py::Linear`` and ``ModCRConfig.with_quantize``, held against
the JAX package's ``ops/quant.py`` and its int8 forward on the CPU, on the
same numpy inputs and weights (``params_from_jax``).

Codes, scales and the int32 accumulator are compared for equality; the
rescaled outputs within 1e-6 relative (one fp32 multiply chain each side).
The whole-model tests start from the fp32 tolerance of the unquantized
tests (2e-4, tests/test_torch_models.py).  JAX and the port reach the same
fp32 activations up to the order of a few sums, so a code comes out
differently only where an activation lands within that rounding of a .5
tie, and then it moves by one step: the product term by one
``x_scale * w_scale * w_code``, a logit by up to about 1e-2 at these widths.
The JAX model forward stays close enough that no code flips on these
seeded inputs, and the model test holds every logit to 2e-4.  The jitted
JAX scorer fuses its sums differently, and a few codes flip: the scorer test
holds every logit to 2e-2 (a flipped code or two), three in four to 2e-4
(no flip reached them), and the predictions equal where the top two logits
lie more than 4e-2 apart.  Parameters held in bf16 are quantized from their
bf16 values, as the JAX function casts them; that is held on one quantized
encoder layer against the op-by-op JAX layer to 1e-5.  (With bf16
parameters the jitted JAX model moves every logit by about 8e-3 from its
own op-by-op forward, which the port matches to 3e-7.)
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.data import schemas as jschemas
from multimodal_context_reasoning_tpu.data import tokenization as jtok
from multimodal_context_reasoning_tpu.models import layers as jlayers
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.ops import quant as jquant
from multimodal_context_reasoning_tpu.serving.scorer import ModCRScorer as JScorer
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.data import schemas as tschemas
from multimodal_context_reasoning_torch.data import tokenization as ttok
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.layers import Linear, freeze_int8
from multimodal_context_reasoning_torch.models.layers import TransformerLayer as TLayer
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.ops import quant as tquant
from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer as TScorer
from tests.test_torch_models import make_batch

TOL = dict(rtol=2e-4, atol=2e-4)
FLIP_TOL = 2e-2   # a logit moved by a code or two flipped at a rounding tie
CHOICES = ["they hug .", "they fight .", "they leave .", "they sing ."]


def _activations(rng, rows=12, k=40):
    x = rng.normal(size=(rows, k)).astype(np.float32) * rng.uniform(0.1, 5, (rows, 1))
    x[3] = 0.0                      # an all-zero row: scale 1, codes 0
    return x


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_quantize_symmetric_equals_jax(dtype):
    rng = np.random.default_rng(0)
    x = _activations(rng)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    for axis in (0, 1):
        jq, js = jquant.quantize_symmetric(jx, axis=axis)
        tq, ts = tquant.quantize_symmetric(tx, dim=axis)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert np.abs(tq.numpy()).max() == 127
    assert ts[3].item() == 1.0 and not tq[3].any()


def test_int8_accumulator_equals_jax():
    rng = np.random.default_rng(1)
    x, w = _activations(rng, 20, 48), rng.normal(size=(48, 24)).astype(np.float32)
    jxq, _ = jquant.quantize_symmetric(jnp.asarray(x), axis=1)
    jwq, _ = jquant.quantize_symmetric(jnp.asarray(w), axis=0)
    jacc = jax.lax.dot_general(jxq, jwq, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    txq, _ = tquant.quantize_symmetric(torch.from_numpy(x), 1)
    twq, _ = tquant.quantize_symmetric(torch.from_numpy(w.T.copy()), 1)
    plain = tquant.int8_mm_plain(txq, twq)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jacc))
    # a CPU tensor takes the plain version
    assert torch.equal(tquant.int8_mm(txq, twq), plain)
    # exact at a full-width inner size too, where an fp32 sum would not be
    big = torch.full((2, 4096), 127, dtype=torch.int8)
    assert tquant.int8_mm_plain(big, big).unique().tolist() == [4096 * 127 * 127]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(bias, out_dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 40)).astype(np.float32)
    w = rng.normal(size=(40, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32) if bias else None
    want = jquant.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                              None if b is None else jnp.asarray(b),
                              out_dtype=getattr(jnp, out_dtype))
    got = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                             None if b is None else torch.from_numpy(b),
                             getattr(torch, out_dtype))
    assert got.shape == (3, 7, 16) and got.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6, atol=0)
    # the plain route gives the same bits
    plain = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                               None if b is None else torch.from_numpy(b),
                               getattr(torch, out_dtype), plain=True)
    assert torch.equal(plain, got)


def test_int_mm_shape_rules_are_checked():
    ok = torch.zeros(17, 16, dtype=torch.int8), torch.zeros(8, 16, dtype=torch.int8)
    tquant.check_int_mm(*ok)
    for rows, k, n in ((16, 16, 8), (32, 12, 8), (32, 16, 12)):
        with pytest.raises(ValueError, match=rf"x \[{rows}, {k}\] · weight \[{k}, {n}\]"):
            tquant.check_int_mm(torch.zeros(rows, k, dtype=torch.int8),
                                torch.zeros(n, k, dtype=torch.int8))


@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
def test_frozen_codes_are_the_bits_of_quantizing_per_call(weight_dtype):
    torch.manual_seed(0)
    lin = Linear(40, 24, torch.float32, quantize=True).to(weight_dtype)
    x = torch.randn(5, 9, 40)
    per_call = lin(x)
    keys = set(lin.state_dict())
    freeze_int8(lin)
    assert lin.int8_codes.dtype == torch.int8 and lin.int8_scale.dtype == torch.float32
    assert torch.equal(lin(x), per_call)
    assert set(lin.state_dict()) == keys == {"weight", "bias"}


def test_quantize_sites_are_the_jax_ones():
    """The int8 route at exactly the JAX package's ``_dense`` sites: query,
    key, value, the attention output and the FFN's two, in every tower and
    in the CALeC layers' FFNs; the state dict does not change."""
    cfg = TConfig.tiny()
    plain = TModel(cfg, device="cpu")
    quant = TModel(cfg.with_quantize("int8"), device="cpu")
    assert list(quant.state_dict()) == list(plain.state_dict())
    sites = {n.rsplit(".", 1)[0] if n.endswith(".dense") else n
             for n, m in quant.named_modules() if isinstance(m, Linear) and m.quantize}
    suffixes = {s.split(".")[-1] for s in sites}
    assert suffixes == {"query", "key", "value", "output", "intermediate"}
    per_layer = 6
    layers = (2 * cfg.global_encoder.num_hidden_layers + cfg.roberta.num_hidden_layers)
    assert len(sites) == per_layer * layers + 2 * cfg.chunkalign.cls_layer_num
    assert not any(m.quantize for m in plain.modules() if isinstance(m, Linear))


@pytest.fixture(scope="module")
def jax_params():
    cfg = JConfig.tiny()
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg).items()}
    return jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0), batch)


def test_quantized_model_matches_the_jax_int8_forward(jax_params):
    jcfg, tcfg = JConfig.tiny().with_quantize("int8"), TConfig.tiny().with_quantize("int8")
    batch = make_batch(jcfg)
    want = jax.jit(JModel(jcfg).apply)(jax_params,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
    sd = params_from_jax(jax.tree.map(np.asarray, jax_params), tcfg)
    logits = {}
    for name, cfg in (("int8", tcfg), ("fp32", TConfig.tiny())):
        model = TModel(cfg, device="cpu").eval()
        model.load_state_dict(sd)
        with torch.no_grad():
            logits[name] = model({k: torch.from_numpy(v) for k, v in batch.items()}).logits
    np.testing.assert_allclose(logits["int8"].numpy(), np.asarray(want.logits), **TOL)
    # the int8 route was taken: it moves the logits past the tolerance
    assert (logits["int8"] - logits["fp32"]).abs().max() > 10 * TOL["atol"]


def test_bf16_parameters_are_quantized_from_their_bf16_values():
    """One int8 encoder layer with bf16 parameters against the op-by-op JAX
    layer (fp32 compute, the tiny encoder's)."""
    jenc = JConfig.tiny().with_quantize("int8").global_encoder
    tenc = TConfig.tiny().with_quantize("int8").global_encoder
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 6, jenc.hidden_size)).astype(np.float32)
    bias = np.zeros((2, 1, 1, 6), np.float32)
    bias[1, ..., 4:] = -10000.0
    jlayer = jlayers.TransformerLayer(jenc)
    params = jax.jit(jlayer.init)(jax.random.PRNGKey(1), jnp.asarray(h), jnp.asarray(bias))
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)["params"]
    want = jlayer.apply({"params": params}, jnp.asarray(h), jnp.asarray(bias))[0]
    f32 = lambda node: np.asarray(node.astype(jnp.float32))
    sd = {}
    for tkey, (a, b) in {
        "attention.self.query": ("attention", "query"),
        "attention.self.key": ("attention", "key"),
        "attention.self.value": ("attention", "value"),
        "attention.output.dense": ("attention", "out"),
        "intermediate.dense": ("ffn", "intermediate"),
        "output.dense": ("ffn", "output"),
    }.items():
        sd[tkey + ".weight"] = torch.from_numpy(f32(params[a][b]["kernel"]).T.copy())
        sd[tkey + ".bias"] = torch.from_numpy(f32(params[a][b]["bias"]))
    for tkey, (a, b) in {"attention.output.LayerNorm": ("attention", "out_layer_norm"),
                         "output.LayerNorm": ("ffn", "output_layer_norm")}.items():
        sd[tkey + ".weight"] = torch.from_numpy(f32(params[a][b]["scale"]))
        sd[tkey + ".bias"] = torch.from_numpy(f32(params[a][b]["bias"]))
    layer = TLayer(tenc).eval()
    layer.load_state_dict(sd)
    layer.to(torch.bfloat16)
    with torch.no_grad():
        got = layer(torch.from_numpy(h), torch.from_numpy(bias))[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _features(schemas, dim):
    rng = np.random.default_rng(0)
    return {f"img-{i}": schemas.ImageFeatures(
        features=rng.normal(size=(3 + i, dim)).astype(np.float32), num_regions=3 + i)
        for i in range(4)}


def _example(schemas, i):
    return schemas.RawExample(
        example_id=f"e{i}", img_id=f"img-{i % 4}", premise=f"friend {i} waits .",
        answer_choices=CHOICES[i % 4:] + CHOICES[:i % 4], answer_label=None)


def test_quantized_scorer_matches_the_jax_scorer(jax_params):
    """The served path: the port's scorer quantizes once from the weights it
    holds, the JAX scorer per call from its resident params, both fp32."""
    jcfg, tcfg = JConfig.tiny().with_quantize("int8"), TConfig.tiny().with_quantize("int8")
    dim, vocab, rob = (jcfg.global_encoder.img_feature_dim, jcfg.global_encoder.vocab_size,
                       jcfg.roberta.vocab_size)
    params = jax.tree.map(np.asarray, jax_params)
    jscorer = JScorer(jcfg, params, jtok.HashTokenizer(vocab_size=vocab),
                      jtok.RobertaHashTokenizer(vocab_size=rob), _features(jschemas, dim),
                      micro_batch=2)
    tscorer = TScorer(tcfg, params_from_jax(params, tcfg), ttok.HashTokenizer(vocab_size=vocab),
                      ttok.RobertaHashTokenizer(vocab_size=rob), _features(tschemas, dim),
                      micro_batch=2, device="cpu")
    assert all(m.int8_codes is not None for m in tscorer.model.modules()
               if isinstance(m, Linear) and m.quantize)
    ids = [0, 1, 2, 3, 5]
    want = jscorer.score([_example(jschemas, i) for i in ids])
    got = tscorer.score([_example(tschemas, i) for i in ids])
    assert_int8_close([r["logits"] for r in got], [r["logits"] for r in want])


def assert_int8_close(got, want):
    """Logits [N, K] of an int8 forward against the jitted JAX one: all
    within a flipped code or two, three in four with no flip, and the same
    decision wherever the top two are further apart than two flips."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    assert err.max() <= FLIP_TOL and (err <= TOL["atol"]).mean() >= 0.75, err
    top2 = np.sort(want, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * FLIP_TOL
    assert (got.argmax(1) == want.argmax(1))[decided].all()


def test_with_quantize_round_trips_through_json():
    cfg = TConfig.tiny().with_quantize("int8")
    towers = ("global_encoder", "seq_encoder", "roberta")
    assert all(getattr(cfg, t).quantize == "int8" for t in towers)
    back = TConfig.from_json(cfg.to_json())
    assert back == cfg
    jcfg = JConfig.from_json(cfg.to_json())
    assert jcfg == JConfig.tiny().with_quantize("int8")
    assert json.loads(jcfg.to_json()) == json.loads(cfg.to_json())
    assert TConfig.from_json(cfg.with_quantize("none").to_json()) == TConfig.tiny()
    assert dataclasses.asdict(cfg.roberta)["quantize"] == "int8"
