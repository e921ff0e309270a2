"""PyTorch port, the ensemble family (``models/ensemble.py``) and the gpt
stream of ``data/vcr.py``, held against the JAX package at
``ModCRConfig.tiny()``: ``CandidateEnsemble`` (every fusion and loss),
``VoteEnsemble`` and ``pairwise_hinge_loss``; ``DualEnsembleModel`` with both
text views, its forward (logits, loss, alignment loss) and its gradients
against ``jax.grad``; and the JAX tests of ``tests/test_ensemble_gpt.py`` on
examples the test writes (the stream framing, no RoBERTa tower under the
``gpt2`` view, the degenerate ``first`` pool, ``last_real`` separating the
candidates).  Weights cross over by ``interop/from_jax.py``; fp32, atol =
rtol = 2e-4 (the bound of the other port tests)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.cli.common import batch_spec as jbatch_spec
from multimodal_context_reasoning_tpu.core.config import GPT2Config as JGPT2Config
from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.data import schemas as jschemas
from multimodal_context_reasoning_tpu.data.tokenization import HashTokenizer as JHash
from multimodal_context_reasoning_tpu.data.vcr import VCRDataset as JVCRDataset
from multimodal_context_reasoning_tpu.models import ensemble as jens
from multimodal_context_reasoning_torch.cli.common import batch_spec
from multimodal_context_reasoning_torch.core.config import GPT2Config, ModCRConfig
from multimodal_context_reasoning_torch.data.schemas import ImageFeatures, RawExample
from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
from multimodal_context_reasoning_torch.data.vcr import VCRDataset
from multimodal_context_reasoning_torch.interop.from_jax import (
    dual_ensemble_params_from_jax,
    ensemble_params_from_jax,
)
from multimodal_context_reasoning_torch.models import ensemble as tens
from tests.test_torch_models import make_batch

TOL = dict(rtol=2e-4, atol=2e-4)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side is tiny: one intra-op thread keeps it off the cores
    the other test workers use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL, err_msg=what)


# ------------------------------------------------------------ the heads

def _views(Q=3, K=4):
    rng = np.random.default_rng(0)
    label = np.zeros((Q * K,), np.float32)
    label[::K] = 1.0
    return {"calec": rng.normal(size=(Q * K, 8)).astype(np.float32),
            "roberta": rng.normal(size=(Q * K, 12)).astype(np.float32)}, label


def _heads_match(jmodel, tmodel, jargs, targs):
    params = jax.tree.map(np.asarray, jmodel.init(KEY, *jargs))
    tmodel.load_state_dict(ensemble_params_from_jax(params), strict=True)
    want = jmodel.apply(params, *jargs)
    got = tmodel(*targs)
    _close(got.logits, want.logits, "logits")
    _close(got.loss, want.loss, "loss")
    return got


@pytest.mark.parametrize("fusion", ["concat", "add"])
@pytest.mark.parametrize("loss", ["ce", "hinge", "ce+hinge"])
def test_vector_fusions_match_jax(fusion, loss):
    views, label = _views()
    got = _heads_match(
        jens.CandidateEnsemble(fusion=fusion, loss=loss),
        tens.CandidateEnsemble({"calec": 8, "roberta": 12}, fusion=fusion, loss=loss),
        ({k: jnp.asarray(v) for k, v in views.items()}, jnp.asarray(label)),
        ({k: torch.from_numpy(v) for k, v in views.items()}, torch.from_numpy(label)))
    assert got.logits.shape == (3, 4) and torch.isfinite(got.loss)


@pytest.mark.parametrize("fusion", ["logit_add", "learned_add"])
def test_logit_fusions_match_jax(fusion):
    rng = np.random.default_rng(1)
    views = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=(12, 1)).astype(np.float32)}
    label = np.zeros((12,), np.float32)
    label[::4] = 1.0
    jm = jens.CandidateEnsemble(fusion=fusion)
    jv = {k: jnp.asarray(v) for k, v in views.items()}
    params = jax.tree.map(np.asarray, jm.init(KEY, jv, jnp.asarray(label)))
    if fusion == "learned_add":   # gates away from their init of 1
        params["params"]["view_gates"] = np.asarray([0.3, -1.7], np.float32)
    tm = tens.CandidateEnsemble({"a": 1, "b": 1}, fusion=fusion)
    tm.load_state_dict(ensemble_params_from_jax(params), strict=True)
    want = jm.apply(params, jv, jnp.asarray(label))
    got = tm({k: torch.from_numpy(v) for k, v in views.items()}, torch.from_numpy(label))
    _close(got.logits, want.logits, "logits")
    _close(got.loss, want.loss, "loss")
    if fusion == "logit_add":
        np.testing.assert_allclose(got.logits.numpy(), views["a"] + views["b"].reshape(3, 4),
                                   rtol=1e-6)


def test_vote_matches_jax():
    rng = np.random.default_rng(2)
    ml = rng.normal(size=(5, 3, 4)).astype(np.float32)
    label = np.eye(4, dtype=np.float32)[[0, 1, 2]]
    got = _heads_match(jens.VoteEnsemble(), tens.VoteEnsemble(num_models=5),
                       (jnp.asarray(ml), jnp.asarray(label)),
                       (torch.from_numpy(ml), torch.from_numpy(label)))
    assert got.logits.shape == (3, 4)


@pytest.mark.parametrize("use_probs", [False, True])
def test_pairwise_hinge_matches_jax(use_probs):
    """Multi-hot rows with one gold, two golds and none (the gold mean
    divides by max(count, 1))."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 4)).astype(np.float32) * 3
    targets = np.array([[1, 0, 0, 0], [0, 1, 1, 0], [0, 0, 0, 0]], np.float32)
    want = jens.pairwise_hinge_loss(jnp.asarray(logits), jnp.asarray(targets), 0.5,
                                    use_probs=use_probs)
    got = tens.pairwise_hinge_loss(torch.from_numpy(logits), torch.from_numpy(targets), 0.5,
                                   use_probs=use_probs)
    _close(got, want, "hinge")


def test_hinge_zero_when_gold_dominates():
    """Every competitor prob ~0, gold ~1: relu(0.5 + p - 1) is 0 for the
    competitors and 0.5 for the gold itself (the JAX test's case)."""
    val = tens.pairwise_hinge_loss(torch.tensor([[100.0, 0.0, 0.0, 0.0]]),
                                   torch.tensor([[1.0, 0.0, 0.0, 0.0]]), margin=0.5,
                                   use_probs=True)
    np.testing.assert_allclose(float(val), 0.5, atol=1e-3)


def test_unknown_options_raise():
    with pytest.raises(ValueError, match="unknown fusion"):
        tens.CandidateEnsemble({"a": 1}, fusion="max")
    cfg = ModCRConfig.tiny()
    with pytest.raises(ValueError, match="unknown text_view"):
        tens.DualEnsembleModel(cfg, text_view="bert", device="cpu")
    with pytest.raises(ValueError, match="unknown gpt_pool"):
        tens.DualEnsembleModel(cfg, text_view="gpt2", gpt_pool="mean", device="cpu")


# ------------------------------------------------------------ the gpt stream

PREMISES = ["a dog <|det1|> sits", "the man <|det2|> runs", "two <|det3|> cats play"]
ANSWERS = [["he is happy", "she waits", "it rains now", "yes"],
           ["no", "he is tired", "they left", "a red car"],
           ["fast", "under the table", "cats sleep", "maybe not"]]


def _gpt2_config(cfg, lib=GPT2Config):
    """GPT-2 of the JAX test: 2 layers, 2 heads, at the encoders' width."""
    return lib(vocab_size=cfg.roberta.vocab_size, n_positions=cfg.roberta_len + 2,
               n_embd=cfg.global_encoder.hidden_size, n_layer=2, n_head=2,
               add_cross_attention=False)


def _datasets(lm_style="gpt"):
    """The same examples through the JAX and the port ``VCRDataset``; the
    second-view tokenizer is the JAX test's GPT-2 stand-in (bos and eos
    both ``<|endoftext|>``)."""
    cfg = JConfig.tiny()
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(len(PREMISES), 5, cfg.global_encoder.img_feature_dim)
                       ).astype(np.float32)
    out = []
    for schemas, hash_tok, cls, spec in (
            (jschemas, JHash, JVCRDataset, jbatch_spec(cfg)),
            (None, HashTokenizer, VCRDataset, batch_spec(ModCRConfig.tiny()))):
        Raw = jschemas.RawExample if schemas else RawExample
        Img = jschemas.ImageFeatures if schemas else ImageFeatures
        examples = [Raw(example_id=f"ex-{i}", img_id=f"img-{i}", premise=p,
                        answer_choices=ANSWERS[i], answer_label=i % 4)
                    for i, p in enumerate(PREMISES)]
        images = {f"img-{i}": Img(features=feats[i], num_regions=5)
                  for i in range(len(PREMISES))}
        gpt_tok = hash_tok(vocab_size=cfg.roberta.vocab_size, cls_token="<|endoftext|>",
                           sep_token="<|endoftext|>")
        out.append(cls(examples, images, hash_tok(vocab_size=cfg.global_encoder.vocab_size),
                       gpt_tok, spec=spec, max_chunks=cfg.max_chunks, lm_style=lm_style))
    return out


def test_gpt_stream_framing_matches_jax():
    """lm_style='gpt': no prompt template, no 'Answer is' prefix, the stream
    [bos] que [eos] ans [eos] (Data/VCRChunkAlign.py:417-421); every array
    of a batch equals the JAX dataset's."""
    jds, tds = _datasets()
    ex = tds.examples[0]
    tok = tds.roberta
    que = tok.tokenize(ex.premise.lower())
    for ans_idx, c in enumerate(tds.featurize(ex)):
        want = ([tok.cls_token] + que + [tok.sep_token]
                + tok.tokenize(ex.answer_choices[ans_idx]) + [tok.sep_token])[:20]
        np.testing.assert_array_equal(c.r_input_ids, tok.convert_tokens_to_ids(want))
    jb, tb = jds.batch([0, 1, 2]), tds.batch([0, 1, 2])
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_prompt_style_differs_and_unknown_style_raises():
    (_, gpt), (_, prompt) = _datasets("gpt"), _datasets("prompt")
    a = gpt.featurize(gpt.examples[0])[0].r_input_ids
    b = prompt.featurize(prompt.examples[0])[0].r_input_ids
    assert a.shape != b.shape or not np.array_equal(a, b)
    with pytest.raises(ValueError, match="unknown lm_style 'bart'"):
        VCRDataset(gpt.examples, gpt.image_features, gpt.bert, gpt.roberta, lm_style="bart")


# ------------------------------------------------------------ DualEnsembleModel

def _random_params(jmodel, batch, seed):
    """A parameter tree of the JAX init's shapes (traced, not compiled) with
    seeded values: LayerNorm scales near 1, the rest N(0, 0.2²)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda b: jmodel.init(KEY, b), _j(batch))

    def draw(path, leaf):
        x = rng.normal(size=leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if path[-1].key == "scale" else 0.2 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


# (view, gpt_pool, fusion, loss): each view with both heads' fusions
CASES = {
    "roberta-concat-ce+hinge": ("roberta", "first", "concat", "ce+hinge"),
    "roberta-add-ce": ("roberta", "first", "add", "ce"),
    "gpt2-first-concat-ce": ("gpt2", "first", "concat", "ce"),
    "gpt2-last_real-add-hinge": ("gpt2", "last_real", "add", "hinge"),
}


@pytest.fixture(scope="module")
def dual():
    """Per case: the JAX model, its parameters, the port model carrying them
    and the batch (the gpt cases on the gpt-framed dataset's batch)."""
    jcfg, tcfg = JConfig.tiny(), ModCRConfig.tiny()
    rob_batch = make_batch(jcfg)
    gpt_batch = dict(_datasets()[1].batch([0, 1, 2]))
    out = {}
    for i, (name, (view, pool, fusion, loss)) in enumerate(CASES.items()):
        batch = gpt_batch if view == "gpt2" else rob_batch
        jm = jens.DualEnsembleModel(jcfg, fusion=fusion, loss=loss, text_view=view,
                                    gpt_pool=pool, gpt2_config=_gpt2_config(jcfg, JGPT2Config))
        params = _random_params(jm, batch, seed=i)
        tm = tens.DualEnsembleModel(tcfg, fusion=fusion, loss=loss, text_view=view,
                                    gpt_pool=pool, gpt2_config=_gpt2_config(tcfg),
                                    device="cpu").eval()
        tm.load_state_dict(dual_ensemble_params_from_jax(params, tcfg, text_view=view),
                           strict=True)
        out[name] = dict(j=jm, t=tm, params=params, batch=batch)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_dual_ensemble_forward_matches_jax(dual, case):
    s = dual[case]
    want, want_align = jax.jit(lambda p, b: s["j"].apply(p, b))(s["params"], _j(s["batch"]))
    with torch.no_grad():
        got, got_align = s["t"](_t(s["batch"]))
    _close(got.logits, want.logits, "logits")
    _close(got.loss, want.loss, "loss")
    _close(got_align, want_align, "align_loss")
    assert got.logits.shape == (3 if CASES[case][0] == "gpt2" else 2, 4)
    assert float(got_align) > 0


@pytest.mark.parametrize("case", ["roberta-concat-ce+hinge", "gpt2-last_real-add-hinge"])
def test_dual_ensemble_gradients_match_jax(dual, case):
    """Gradients of loss + alignment loss, every parameter against
    ``jax.grad`` (mapped by the same function as the weights)."""
    s = dual[case]
    view = CASES[case][0]
    batch = _j(s["batch"])

    def total(p):
        out, align = s["j"].apply(p, batch)
        return out.loss + align

    jgrads = jax.jit(jax.grad(total))(s["params"])
    want = dual_ensemble_params_from_jax(jax.tree.map(np.asarray, jgrads),
                                         ModCRConfig.tiny(), text_view=view)
    model = s["t"]
    named = list(model.named_parameters())
    out, align = model(_t(s["batch"]))
    grads = torch.autograd.grad(out.loss + align, [p for _, p in named], allow_unused=True)
    touched = 0
    for (name, _), g in zip(named, grads):
        w = want[name].numpy()
        if g is None:
            # only the unused edge_dense table goes without a gradient
            assert name == "seq_enc.edge_dense.weight" and not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
        touched += bool(np.abs(w).max() > 0)
    assert touched > 100


def test_gpt2_view_has_no_roberta_tower(dual):
    s = dual["gpt2-first-concat-ce"]
    assert {"gpt"} <= set(s["params"]["params"]) and "roberta" not in s["params"]["params"]
    names = {n.split(".")[0] for n, _ in s["t"].named_parameters()}
    assert names == {"global_enc", "seq_enc", "fusion", "gpt", "ensemble"}


def test_first_pool_is_degenerate_by_reference_design(dual):
    """The reference pools position 0 (ensemble:273): under causal attention
    it sees only <bos>, so the text view is the same for every candidate."""
    s = dual["gpt2-first-concat-ce"]
    with torch.no_grad():
        first = s["t"].text_cls(_t(s["batch"]))
    torch.testing.assert_close(first, first[:1].expand_as(first), atol=1e-5, rtol=0)


def test_last_real_pool_separates_candidates(dual):
    """The last non-pad hidden differs between the candidates' answers, so
    the pooled views and the logits vary within each question."""
    s = dual["gpt2-last_real-add-hinge"]
    batch = _t(s["batch"])
    with torch.no_grad():
        pooled = s["t"].text_cls(batch).view(3, 4, -1)
        logits = s["t"](batch)[0].logits
    assert (pooled[:, 1:] - pooled[:, :1]).abs().amax(dim=(1, 2)).min() > 1e-3
    assert np.ptp(logits.numpy(), axis=1).min() > 0


def test_default_gpt2_view_is_gpt2_small_at_the_encoders_width():
    model = tens.DualEnsembleModel(ModCRConfig.tiny(), text_view="gpt2", device="cpu")
    c = model.gpt.config
    assert (c.n_embd, c.n_layer, c.n_head, c.vocab_size, c.add_cross_attention) == \
        (32, 12, 12, 50257, False)
    assert dataclasses.replace(c, n_embd=768) == GPT2Config(add_cross_attention=False)
