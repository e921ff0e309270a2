"""PyTorch port, the rationale-generation family: ``models/gpt2.py``,
``models/rationale.py``, ``generation/{decode,api}.py``, ``data/rationale.py``
and the JAX -> port key mapping ``rationale_params_from_jax``, held against
the JAX package on the CPU with the same numpy inputs and weights.

Tolerances: GPT-2 logits (prefill, full forward, one cached step) within
1e-5 (fp32, the bound tests/test_generation.py holds the cache to); greedy
tokens and lengths exactly; the top-k/top-p filter exactly; the rationale
model's probabilities, decoder memory and losses within 1e-5, its summed
reasoning-layer attention within the bound :func:`cls_attn_bound` works out
(see there); the rationale family's 4-step ``Trainer.fit`` trajectory
(``RationaleForTraining``, encoders trainable) at the trajectory tolerance
of tests/test_torch_train.py.  Sampling draws cannot match JAX's PRNG:
top-k = 1 sampling is held to greedy, and the rest by determinism under a
seed and by support.  Beam and CBS decoding: tests/test_torch_{beam,fsm}.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import ChunkAlignConfig as JSched
from multimodal_context_reasoning_tpu.core.config import EncoderConfig as JEnc
from multimodal_context_reasoning_tpu.core.config import GPT2Config as JGPT2
from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.data import rationale as jrationale
from multimodal_context_reasoning_tpu.data.tokenization import HashTokenizer as JHash
from multimodal_context_reasoning_tpu.generation.decode import greedy_decode as jgreedy
from multimodal_context_reasoning_tpu.generation.decode import top_k_top_p_filter as jfilter
from multimodal_context_reasoning_tpu.interop import assemble as jassemble
from multimodal_context_reasoning_tpu.interop.export import export_rationale_state_dict
from multimodal_context_reasoning_tpu.models.gpt2 import GPT2Decoder as JDecoder
from multimodal_context_reasoning_tpu.models.gpt2 import KVCache as JCache
from multimodal_context_reasoning_tpu.models.rationale import RationaleModel as JRationale
from multimodal_context_reasoning_tpu.models.rationale import rationale_init_batch
from multimodal_context_reasoning_tpu.ops.chunk import chunk_mask_from_gather_index
from multimodal_context_reasoning_torch.core.config import ChunkAlignConfig as TSched
from multimodal_context_reasoning_torch.core.config import EncoderConfig as TEnc
from multimodal_context_reasoning_torch.core.config import GPT2Config as TGPT2
from multimodal_context_reasoning_torch.data import rationale as trationale
from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer as THash
from multimodal_context_reasoning_torch.generation.api import generate
from multimodal_context_reasoning_torch.generation.decode import greedy_decode, sample_decode
from multimodal_context_reasoning_torch.generation.decode import top_k_top_p_filter
from multimodal_context_reasoning_torch.interop import assemble as tassemble
from multimodal_context_reasoning_torch.interop.from_jax import (
    gpt2_params_from_jax,
    rationale_params_from_jax,
)
from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder, KVCache
from multimodal_context_reasoning_torch.models.rationale import RationaleModel
from tests.test_torch_models import make_batch

V = 128
GPT2_KW = dict(vocab_size=V, n_positions=96, n_embd=32, n_layer=2, n_head=4,
               resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, pad_token_id=0)
ENC_KW = dict(vocab_size=256, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
              intermediate_size=64, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, max_position_embeddings=128,
              img_feature_dim=20)
SCHED_KW = dict(chunk_layers_end=1, full_layers_end=2)
GEN = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def gpt2():
    """The JAX decoder of tests/test_generation.py (tied head) and the port's
    with its weights; a prompt, a memory and its mask."""
    jmodel = JDecoder(JGPT2(**GPT2_KW))
    rng = np.random.default_rng(0)
    B, Lp, M = 2, 6, 5
    prompt = rng.integers(2, V, size=(B, Lp)).astype(np.int32)
    mem = rng.normal(size=(B, M, 32)).astype(np.float32)
    mmask = np.ones((B, M), np.float32)
    mmask[1, 3:] = 0.0
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(prompt), memory=jnp.asarray(mem),
                         memory_mask=jnp.asarray(mmask))
    tmodel = GPT2Decoder(TGPT2(**GPT2_KW)).eval()
    tmodel.load_state_dict(gpt2_params_from_jax(jax.tree.map(np.asarray, params), 2))
    return dict(j=jmodel, params=params, t=tmodel, prompt=prompt, mem=mem, mmask=mmask)


def _j(g, *args, **kw):
    return g["j"].apply(g["params"], *args, **kw)


def test_gpt2_full_forward_and_cached_prefill_match_jax(gpt2):
    prompt, mem, mmask = gpt2["prompt"], gpt2["mem"], gpt2["mmask"]
    B, Lp = prompt.shape
    jkw = dict(memory=jnp.asarray(mem), memory_mask=jnp.asarray(mmask))
    tkw = dict(memory=_t(mem), memory_mask=_t(mmask))
    want, _ = _j(gpt2, jnp.asarray(prompt), **jkw)
    jcached, jcache = _j(gpt2, jnp.asarray(prompt), cache=JCache.zeros(gpt2["j"].config, B, Lp + 4),
                         cache_index=jnp.int32(0), **jkw)
    with torch.no_grad():
        got, _ = gpt2["t"](_t(prompt).long(), **tkw)
        cache = KVCache.zeros(gpt2["t"].config, B, Lp + 4, "cpu")
        cached, cache = gpt2["t"](_t(prompt).long(), cache=cache, cache_index=0, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEN)
    np.testing.assert_allclose(cached.numpy(), np.asarray(jcached), **GEN)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **GEN)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), **GEN)


def test_gpt2_incremental_step_matches_jax_and_the_full_forward(gpt2):
    """A cached step with a per-row [B] position offset: the JAX step's
    logits, and the last position of the full forward over prompt + token."""
    prompt, mem, mmask = gpt2["prompt"], gpt2["mem"], gpt2["mmask"]
    B, Lp = prompt.shape
    nxt = np.asarray([[5], [9]], np.int32)
    jkw = dict(memory=jnp.asarray(mem), memory_mask=jnp.asarray(mmask))
    tkw = dict(memory=_t(mem), memory_mask=_t(mmask))
    _, jcache = _j(gpt2, jnp.asarray(prompt), cache=JCache.zeros(gpt2["j"].config, B, Lp + 4),
                   cache_index=jnp.int32(0), **jkw)
    jstep, _ = _j(gpt2, jnp.asarray(nxt), position_offset=jnp.full((B,), Lp, jnp.int32),
                  cache=jcache, cache_index=jnp.int32(Lp), **jkw)
    with torch.no_grad():
        cache = KVCache.zeros(gpt2["t"].config, B, Lp + 4, "cpu")
        _, cache = gpt2["t"](_t(prompt).long(), cache=cache, cache_index=0, **tkw)
        step, _ = gpt2["t"](_t(nxt).long(), position_offset=torch.full((B,), Lp),
                            cache=cache, cache_index=Lp, **tkw)
        full, _ = gpt2["t"](torch.cat([_t(prompt), _t(nxt)], 1).long(), **tkw)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **GEN)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), **GEN)


_JAX_GREEDY = {}


def _jax_greedy(model):
    """The JAX greedy decode, jitted once for every eos id (a traced one)."""
    if model not in _JAX_GREEDY:
        _JAX_GREEDY[model] = jax.jit(
            lambda p, prompt, plen, mem, mmask, eos: jgreedy(
                model, p, prompt, plen, memory=mem, memory_mask=mmask, max_len=10,
                eos_id=eos, pad_id=0))
    return _JAX_GREEDY[model]


@pytest.mark.parametrize("eos_id", [1, 84, 24], ids=["never", "row-0", "row-1"])
def test_greedy_tokens_and_lengths_equal_jax(gpt2, eos_id):
    """A right-padded prompt (the second row's last two slots), and eos ids
    that end no row, the first row early, or the second mid-sequence."""
    prompt, mem, mmask = gpt2["prompt"], gpt2["mem"], gpt2["mmask"]
    plen = np.asarray([6, 4], np.int32)
    jt, jl = _jax_greedy(gpt2["j"])(gpt2["params"], jnp.asarray(prompt), jnp.asarray(plen),
                                    jnp.asarray(mem), jnp.asarray(mmask), eos_id)
    tt, tl = greedy_decode(gpt2["t"], _t(prompt).long(), _t(plen), memory=_t(mem),
                           memory_mask=_t(mmask), max_len=10, eos_id=eos_id, pad_id=0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    if eos_id != 1:
        assert (tl.numpy() < 10).any() and (tt.numpy() == 0).any()


@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (5, 1.0), (5, 0.7), (0, 0.3),
                                         (50, 0.95), (3, 0.05), (1, 1.0)])
def test_top_k_top_p_filter_equals_jax(top_k, top_p):
    logits = np.random.default_rng(17).normal(size=(6, 40)).astype(np.float32) * 2.0
    want = np.asarray(jfilter(jnp.asarray(logits), top_k, top_p))
    got = top_k_top_p_filter(_t(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > -1e8).any(axis=-1).all()


def _sample(gpt2, seed, **kw):
    prompt, mem, mmask = gpt2["prompt"], gpt2["mem"], gpt2["mmask"]
    return sample_decode(gpt2["t"], _t(prompt).long(), torch.as_tensor([6, 4]),
                         generator=torch.Generator().manual_seed(seed), memory=_t(mem),
                         memory_mask=_t(mmask), max_len=8, eos_id=1, pad_id=0, **kw)


def test_top_k_1_sampling_is_greedy(gpt2):
    prompt, mem, mmask = gpt2["prompt"], gpt2["mem"], gpt2["mmask"]
    want = greedy_decode(gpt2["t"], _t(prompt).long(), torch.as_tensor([6, 4]),
                         memory=_t(mem), memory_mask=_t(mmask), max_len=8, eos_id=1, pad_id=0)
    for seed in (0, 1):
        got = _sample(gpt2, seed, top_k=1, temperature=0.7)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_sampling_repeats_under_a_seed_and_stays_in_the_kept_set(gpt2):
    """Every sampled token lies in the top-3 of the logits that drew it
    (teacher-forced over the prompt and the sampled tokens)."""
    a, b, c = (_sample(gpt2, s, top_k=3, temperature=1.5) for s in (3, 3, 4))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    prompt = _t(gpt2["prompt"]).long()
    for row, plen in enumerate((6, 4)):
        seq = torch.cat([prompt[row, :plen], a[0][row]])[None]
        with torch.no_grad():
            logits, _ = gpt2["t"](seq, memory=_t(gpt2["mem"][row:row + 1]),
                                  memory_mask=_t(gpt2["mmask"][row:row + 1]))
        top3 = logits[0, plen - 1:-1].topk(3).indices
        assert (top3 == a[0][row, :, None]).any(-1).all()


def test_generate_dispatch_and_refusals(gpt2):
    prompt, plen = _t(gpt2["prompt"]).long(), torch.as_tensor([6, 4])
    kw = dict(memory=_t(gpt2["mem"]), memory_mask=_t(gpt2["mmask"]), max_len=4, eos_id=1)
    want = greedy_decode(gpt2["t"], prompt, plen, **kw)
    got = generate(gpt2["t"], prompt, plen, mode="greedy", **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    sampled = generate(gpt2["t"], prompt, plen, mode="sample", top_k=1,
                       generator=torch.Generator().manual_seed(0), **kw)
    assert all(torch.equal(g, w) for g, w in zip(sampled, want))
    with pytest.raises(ValueError, match="Generator"):
        generate(gpt2["t"], prompt, plen, mode="sample", **kw)
    with pytest.raises(ValueError, match="mode='beam' requires a torch.Generator"):
        generate(gpt2["t"], prompt, plen, mode="beam", **kw)
    with pytest.raises(ValueError, match="mode='cbs' requires fsm_adjacency"):
        generate(gpt2["t"], prompt, plen, mode="cbs", **kw)
    with pytest.raises(ValueError, match="unknown mode"):
        generate(gpt2["t"], prompt, plen, mode="nucleus", **kw)


# ---------------------------------------------------------------- the model

def test_rationale_init_batch_equals_jax():
    from multimodal_context_reasoning_torch.models.rationale import (
        rationale_init_batch as port_init_batch,
    )

    want = rationale_init_batch(JEnc(**ENC_KW), JGPT2(**GPT2_KW), JConfig.tiny(), seed=4)
    got = port_init_batch(TEnc(**ENC_KW), TGPT2(**GPT2_KW), JConfig.tiny(), seed=4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_collate_rationales_equals_jax():
    texts = ["the man waves at <|det1|> .", None, "a dog sleeps"]
    spec = dict(max_len=6, pad_id=0)
    want = jrationale.collate_rationales(texts, JHash(vocab_size=V),
                                         jrationale.RationaleSpec(**spec))
    got = trationale.collate_rationales(texts, THash(vocab_size=V),
                                        trationale.RationaleSpec(**spec))
    assert set(got) == set(want) == {"expl_ids", "gpt_labels", "expl_mask"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def rationale():
    """The JAX rationale model at the tiny geometry, its parameters, the
    port's model with them, and a collate-shaped batch of 2 questions with
    real chunk ids, labels and explanation streams."""
    enc, sched, gpt = JEnc(**ENC_KW), JSched(**SCHED_KW), JGPT2(**GPT2_KW)
    jmodel = JRationale(enc, sched, gpt, max_chunks=8)
    spec = JConfig.tiny()
    init = rationale_init_batch(enc, gpt, spec)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  {k: jnp.asarray(v) for k, v in init.items()})
    params = jax.tree.map(np.asarray, params)
    batch = {k: v for k, v in make_batch(spec).items() if not k.startswith("r_")}
    batch["chunk_mask"] = np.asarray(chunk_mask_from_gather_index(
        jnp.asarray(batch["gather_index"]), jnp.asarray(batch["text_mask"])))
    batch.update(jrationale.collate_rationales(
        ["a man waves .", "two dogs run far away ."], JHash(vocab_size=V),
        jrationale.RationaleSpec(max_len=8)))
    tcfgs = TEnc(**ENC_KW), TSched(**SCHED_KW), TGPT2(**GPT2_KW)
    tmodel = RationaleModel(*tcfgs, max_chunks=8, device="cpu").eval()
    tmodel.load_state_dict(rationale_params_from_jax(params, tcfgs[0], tcfgs[2]))
    return dict(j=jmodel, params=params, t=tmodel, batch=batch, cfgs=(enc, sched, gpt),
                tcfgs=tcfgs)


def cls_attn_bound(model: RationaleModel, batch) -> float:
    """The fp32 bound on |port - JAX| of ``cls_attn``, from the order of the
    arithmetic.

    ``ClsReasonLayer`` takes one head's softmax of RAW scores (no 1/sqrt(d)),
    so a relative rounding difference of the memory or the CLS reaches a
    score multiplied by the score's size, and a softmax moves by at most
    the change of its scores.  Each of the ``depth`` layers before a score
    (encoder layers, then reasoning layers) adds about one fp32 epsilon of
    relative difference between two orders of summation, and ``cls_attn``
    sums ``cls_layer_num`` softmaxes:

        cls_layer_num × max|score| × eps(fp32) × depth

    Evidence (float64 forwards of both packages on these weights, which
    agree to 5e-15): the JAX fp32 ``cls_attn`` lies 0.9e-6–2.8e-6 from
    float64 and the port's 0.8e-6–1.8e-6, which side is nearer turning with
    the instruction set the CPU libraries pick (AVX-512, AVX2, SSE4.2); the
    largest |score| is 19.96, so the bound is 5.0e-5, against 2.73e-5 seen
    in one run of the whole suite and 1.8e-6 here in one process."""
    top = []

    def hook(layer, inputs, _):
        memory, cls, _bias = inputs
        scores = layer.cls_q_proj(cls[:, None, :]) @ layer.align_k_proj(memory).transpose(1, 2)
        top.append(scores.abs().max().item())

    handles = [layer.register_forward_hook(hook) for layer in model.cls_layer]
    try:
        with torch.no_grad():
            model({k: _t(v) for k, v in batch.items()})
    finally:
        for h in handles:
            h.remove()
    depth = model.config.num_hidden_layers + len(model.cls_layer)
    return len(model.cls_layer) * max(top) * torch.finfo(torch.float32).eps * depth


@pytest.mark.parametrize("with_label", [True, False], ids=["label", "argmax"])
def test_rationale_model_matches_jax(rationale, with_label):
    batch = dict(rationale["batch"])
    if not with_label:
        del batch["label"]
    want = jax.jit(rationale["j"].apply)(rationale["params"],
                                         {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = rationale["t"]({k: _t(v) for k, v in batch.items()})
    for name in ("mp_probs", "decoder_memory", "decoder_memory_mask", "gen_loss", "cls_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **GEN, err_msg=name)
    bound = cls_attn_bound(rationale["t"], batch)
    assert 1e-5 < bound < 1e-4
    np.testing.assert_allclose(got.cls_attn.numpy(), np.asarray(want.cls_attn), rtol=0,
                               atol=bound, err_msg="cls_attn")
    assert float(got.gen_loss) > 0 and (float(got.cls_loss) > 0) == with_label


def test_rationale_params_from_jax_equal_the_jax_export(rationale):
    enc, _, gpt = rationale["cfgs"]
    want = export_rationale_state_dict(rationale["params"], enc, gpt)
    got = rationale_params_from_jax(rationale["params"], rationale["tcfgs"][0],
                                    rationale["tcfgs"][2])
    assert set(got) == set(want) == set(rationale["t"].state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_reference_checkpoint_grafts_with_the_jax_report(rationale, tmp_path):
    """A reference-layout rationale .pth (the JAX export, plus GPT-2's mask
    buffers and ClsLayer2's dead attention, with 2 extra vocabulary rows)
    loads into the port with the JAX graft's report, the GPT-2 vocabulary
    sized to the checkpoint."""
    enc, _, gpt = rationale["cfgs"]
    sd = dict(export_rationale_state_dict(rationale["params"], enc, gpt))
    grow = lambda a: np.concatenate([a, np.full((2, a.shape[1]), 0.5, np.float32)])
    sd["dec.wte.weight"], sd["lm_head.weight"] = grow(sd["dec.wte.weight"]), grow(
        sd["lm_head.weight"])
    sd["dec.h.0.attn.bias"] = np.ones((1, 1, 4, 4), np.float32)
    sd["dec.h.1.attn.masked_bias"] = np.asarray(-1e4, np.float32)
    sd["cls_layer.0.attention.self.query.weight"] = np.ones((32, 32), np.float32)
    path = tmp_path / "rationale.pth"
    torch.save({"net": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)

    model, tgpt, report = tassemble.load_rationale_checkpoint(
        str(path), *rationale["tcfgs"], max_chunks=8, device="cpu")
    assert tgpt.vocab_size == V + 2
    import dataclasses
    jgpt = dataclasses.replace(gpt, vocab_size=V + 2)
    jmodel = JRationale(enc, rationale["cfgs"][1], jgpt, max_chunks=8)
    init = rationale_init_batch(enc, jgpt, JConfig.tiny())
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), init))
    jreport = jassemble.assemble_rationale_params(template, enc, jgpt, dict(sd))
    assert report.summary() == jreport.summary()
    assert report.consumed == jreport.consumed and set(report.skipped) == set(jreport.skipped)
    assert len(report.skipped) == 3 and not report.unconsumed
    state = model.state_dict()
    for k, v in sd.items():
        if k in state:
            np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


def test_rationale_model_builds_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        RationaleModel(TEnc(**ENC_KW), TSched(**SCHED_KW), TGPT2(**GPT2_KW))


# ---------------------------------------------------------------- training

TRAIN_STEPS = 4
TRAJ = dict(rtol=1e-4, atol=1e-5)


class _ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _recorded(step, log):
    def run(*args):
        out = step(*args)
        log.append(out[1] if isinstance(out, tuple) else out)
        return out
    return run


def test_rationale_training_follows_the_jax_trajectory(rationale):
    """``RationaleForTraining`` under ``Trainer.fit``, encoders trainable
    (the seq_enc group at lr × seq_enc_lr_scale): four steps from the JAX
    trainer's initial parameters give JAX's losses and parameters; both loss
    terms fall; the trained state dict drives ``RationaleModel`` and the
    serving generator unchanged."""
    from multimodal_context_reasoning_tpu.core.config import TrainConfig as JTrainConfig
    from multimodal_context_reasoning_tpu.models.rationale import (
        RationaleForTraining as JFacade,
    )
    from multimodal_context_reasoning_tpu.train.trainer import Trainer as JTrainer
    from multimodal_context_reasoning_torch.core.config import TrainConfig
    from multimodal_context_reasoning_torch.generation.decode import greedy_decode
    from multimodal_context_reasoning_torch.models.rationale import RationaleForTraining
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator
    from multimodal_context_reasoning_torch.train.trainer import Trainer

    batch = dict(rationale["batch"], example_mask=np.ones((2,), np.float32))
    tkw = dict(learning_rate=1e-3, scheduler="constant", max_steps=TRAIN_STEPS,
               num_train_epochs=100, per_device_batch_size=2, seed=0, freeze_encoders=False)
    enc, sched, gpt = rationale["cfgs"]
    jtrainer = JTrainer(JFacade(JRationale(enc, sched, gpt, max_chunks=8), gen_weight=0.5),
                        JTrainConfig(**tkw), _ListLoader([batch, batch]))
    jstate = jtrainer.init_state()
    start = jax.tree.map(np.asarray, jstate.params)
    jlog = []
    jtrainer.train_step = _recorded(jtrainer.train_step, jlog)
    jend = jax.tree.map(np.asarray, jtrainer.fit(jstate).params)

    tcfgs = rationale["tcfgs"]
    facade = RationaleForTraining(RationaleModel(*tcfgs, max_chunks=8, device="cpu"),
                                  gen_weight=0.5)
    facade.load_state_dict(rationale_params_from_jax(start, tcfgs[0], tcfgs[2]), strict=True)
    inputs = {k: _t(v) for k, v in batch.items() if k != "example_mask"}
    with torch.no_grad():
        first = facade.eval()(inputs)
    trainer = Trainer(facade, TrainConfig(**tkw), _ListLoader([batch, batch]), device="cpu")
    tlog = []
    trainer.train_step = _recorded(trainer.train_step, tlog)
    state = trainer.fit()

    assert len(tlog) == len(jlog) == TRAIN_STEPS and state.optimizer.count == TRAIN_STEPS
    for key in ("loss", "correct", "count"):
        np.testing.assert_allclose([float(m[key]) for m in tlog],
                                   [float(m[key]) for m in jlog], **TRAJ, err_msg=key)
    assert sorted(g["scale"] for g in state.optimizer.groups) == [0.1, 1.0]
    want = rationale_params_from_jax(jend, tcfgs[0], tcfgs[2])
    begin = rationale_params_from_jax(start, tcfgs[0], tcfgs[2])
    got = facade.state_dict()
    assert list(got) == list(RationaleModel(*tcfgs, max_chunks=8, device="cpu").state_dict())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=name)
    for tower in ("global_enc.", "seq_enc."):
        assert any(not torch.equal(got[n], begin[n]) for n in got if n.startswith(tower))
    with torch.no_grad():
        last = facade.eval()(inputs)
    assert float(last.cls_loss) < float(first.cls_loss)
    assert float(last.gen_loss) < float(first.gen_loss)
    assert float(last.loss) < float(first.loss)

    core = RationaleModel(*tcfgs, max_chunks=8, device="cpu").eval()
    core.load_state_dict(got, strict=True)
    gen = RationaleGenerator(*tcfgs, got, None, THash(vocab_size=V), {}, spec=JConfig.tiny(),
                             max_chunks=8, max_rationale_len=6, warm=False, device="cpu")
    with torch.no_grad():
        out = core(inputs)
        served = gen.model(inputs)
        tokens = gen.decode(served)
    np.testing.assert_allclose(out.mp_probs.numpy(), np.exp(last.logits.numpy()), atol=1e-6)
    assert torch.equal(served.mp_probs, out.mp_probs)
    prompt = torch.full((2, 1), gen.b_rtnl)
    want_tokens = greedy_decode(core.dec, prompt, torch.ones(2, dtype=torch.long),
                                memory=out.decoder_memory.float(),
                                memory_mask=out.decoder_memory_mask, max_len=6,
                                eos_id=gen.e_rtnl, pad_id=0)
    assert all(torch.equal(a, b) for a, b in zip(tokens, want_tokens))


def test_gen_loss_reaches_the_decoder_alone(rationale):
    """The decoder memory is detached (JAX's ``stop_gradient``): the
    generation loss has no gradient in the encoders, the reasoning layers or
    the classifier (the gold-row choice carries none), and its gradients in
    the GPT-2 decoder, cross-attention included, are JAX's."""
    batch = {k: jnp.asarray(v) for k, v in rationale["batch"].items()}
    jgrads = jax.jit(jax.grad(lambda p: rationale["j"].apply(p, batch).gen_loss))(
        rationale["params"])
    want = rationale_params_from_jax(jax.tree.map(np.asarray, jgrads), rationale["tcfgs"][0],
                                     rationale["tcfgs"][2])
    model = rationale["t"]
    named = list(model.named_parameters())
    out = model({k: _t(v) for k, v in rationale["batch"].items()})
    grads = torch.autograd.grad(out.gen_loss, [p for _, p in named], allow_unused=True)
    for (name, _), g in zip(named, grads):
        if name.startswith(("dec.", "lm_head.")):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        else:
            assert g is None and not want[name].any(), name
    cross = dict(zip([n for n, _ in named], grads))["dec.h.0.crossattention.c_attn.weight"]
    assert cross.abs().max() > 1e-4
