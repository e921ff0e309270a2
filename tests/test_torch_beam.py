"""PyTorch port, beam sampling and attention-derived constraints:
``generation/{beam,constraints}.py`` and ``generate(mode="beam")``, held
against the JAX package on the CPU with the same numpy inputs and weights
(the GPT-2 decoder of tests/test_torch_generation.py, carried across by
``gpt2_params_from_jax``).

JAX's Gumbel draws are replayed into the port (``noise``), so the sampled
candidates are the same.  Tolerances: tokens, origins, lengths, done flags
and every selection exactly; running and finished scores within 1e-5 (fp32:
the log-softmax of two frameworks); the constraint masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import GPT2Config as JGPT2
from multimodal_context_reasoning_tpu.generation import beam as jbeam
from multimodal_context_reasoning_tpu.generation import constraints as jcons
from multimodal_context_reasoning_tpu.models.gpt2 import GPT2Decoder as JDecoder
from multimodal_context_reasoning_tpu.models.gpt2 import KVCache as JCache
from multimodal_context_reasoning_torch.core.config import GPT2Config as TGPT2
from multimodal_context_reasoning_torch.generation import beam as tbeam
from multimodal_context_reasoning_torch.generation import constraints as tcons
from multimodal_context_reasoning_torch.generation.api import generate
from multimodal_context_reasoning_torch.interop.from_jax import gpt2_params_from_jax
from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder, KVCache

V = 128
GPT2_KW = dict(vocab_size=V, n_positions=96, n_embd=32, n_layer=2, n_head=4,
               resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, pad_token_id=0)
SCORES = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_gumbel(key, steps: int, shape):
    """The draws of JAX's beam loop from ``key``: one split per step."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return np.stack(out)


# ------------------------------------------------------------ selection

def test_stable_top_k_is_lax_top_k_and_a_stable_sort():
    """Rows thick with ties (-inf, -1e9, repeated values, signed values)."""
    rng = np.random.default_rng(5)
    x = rng.choice(np.asarray([-np.inf, -1e9, -3.5, -0.25, 0.0, 0.5, 2.0], np.float32),
                   size=(6, 9, 40))
    x[0, 0] = -np.inf
    x[1] = rng.normal(size=(9, 40)).astype(np.float32)
    for k in (1, 5, 40):
        vals, idx = tbeam.stable_top_k(_t(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        ref = torch.sort(_t(x), dim=-1, descending=True, stable=True)
        np.testing.assert_array_equal(idx.numpy(), ref.indices[..., :k].numpy())
    with pytest.raises(TypeError, match="float32"):
        tbeam.stable_top_k(torch.zeros(3, dtype=torch.float64), 1)


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_repetition_penalty_and_top_k_warp_equal_jax(penalty):
    rng = np.random.default_rng(2)
    logp = rng.normal(size=(4, 30)).astype(np.float32)
    seqs = rng.integers(0, 30, size=(4, 7))
    valid = rng.random((4, 7)) < 0.6
    want = jbeam.apply_repetition_penalty(jnp.asarray(logp), jnp.asarray(seqs),
                                          jnp.asarray(valid), penalty)
    got = tbeam.apply_repetition_penalty(_t(logp), _t(seqs), _t(valid), penalty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in (0, 3, 29, 30):
        np.testing.assert_array_equal(tbeam.top_k_warp(_t(logp), k).numpy(),
                                      np.asarray(jbeam.top_k_warp(jnp.asarray(logp), k)))


def _contexts(B, K, Vv, Lp, steps, prompt_len, cmask, **knobs):
    N = B * K
    p_ids = np.repeat(np.arange(2, 2 + Lp)[None].repeat(B, 0), K, axis=0)
    valid = np.repeat(np.arange(Lp)[None] < prompt_len[:, None], K, axis=0)
    jctx = jbeam.BeamContext(p_ids=jnp.asarray(p_ids), prompt_valid=jnp.asarray(valid),
                             prompt_len=jnp.asarray(prompt_len), cmask=jnp.asarray(cmask),
                             num_beams=K, **knobs)
    tctx = tbeam.BeamContext(p_ids=_t(p_ids).long(), prompt_valid=_t(valid),
                             prompt_len=_t(prompt_len).long(), cmask=_t(cmask),
                             num_beams=K, **knobs)
    L = Lp + steps
    jstate = jbeam.BeamState(
        seqs=jnp.zeros((B, K, L), jnp.int32), beam_scores=jnp.zeros((B, K), jnp.float32),
        cache=JCache(jnp.zeros((1, N, L, 1, 1)), jnp.zeros((1, N, L, 1, 1))),
        cur_len=jnp.int32(0), fin_seqs=jnp.zeros((B, K, L), jnp.int32),
        fin_scores=jnp.full((B, K), -1e9, jnp.float32), fin_count=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), bool), rng=jax.random.PRNGKey(42),
        fin_lens=jnp.zeros((B, K), jnp.int32))
    tstate = tbeam.BeamState(
        seqs=torch.zeros((B, K, L), dtype=torch.long), beam_scores=torch.zeros((B, K)),
        cache=KVCache(torch.arange(N, dtype=torch.float32).reshape(1, N, 1, 1, 1).expand(
            1, N, L, 1, 1), torch.zeros((1, N, L, 1, 1))),
        cur_len=0, fin_seqs=torch.zeros((B, K, L), dtype=torch.long),
        fin_scores=torch.full((B, K), -1e9), fin_count=torch.zeros(B, dtype=torch.long),
        done=torch.zeros(B, dtype=torch.bool), fin_lens=torch.zeros((B, K), dtype=torch.long))
    return jctx, tctx, jstate, tstate


@pytest.mark.parametrize("knobs", [
    dict(eos_id=1, constraint_factor=0.5, repetition_penalty=1.0, top_k=0, length_penalty=1.0),
    # an integer length penalty: the hypothesis and done scores divide by
    # len ** lp, exact for whole powers of whole lengths; at a fractional lp
    # XLA computes the power of the two sites in two fused forms that can
    # differ by an ulp, and the done test then reads an exact tie that the
    # reference (the same expression twice) and the port never split
    dict(eos_id=3, constraint_factor=0.8, repetition_penalty=1.2, top_k=5, length_penalty=2.0),
], ids=["reference", "penalties"])
def test_beam_select_step_matches_jax_step_by_step(knobs):
    """Eight advances from scripted log-probs with JAX's own noise: every field
    of the state equal after every step, the cache gathered by origin."""
    B, K, Vv, Lp, steps = 2, 3, 12, 4, 8
    prompt_len = np.array([4, 3])
    cmask = np.zeros((B, Vv), bool)
    cmask[0, 7] = cmask[0, 8] = cmask[1, 2] = True
    jctx, tctx, jstate, tstate = _contexts(B, K, Vv, Lp, steps, prompt_len, cmask, **knobs)
    script = np.random.default_rng(9)
    jstep = jax.jit(lambda s, lp: jbeam.beam_select_step(s, lp, jctx))
    ids_cache = tstate.cache
    # peaked rows that favour eos, so hypotheses finish and batches freeze
    alpha = np.full(Vv, 0.3)
    alpha[knobs["eos_id"]] = 3.0
    for t in range(steps):
        logp = np.log(script.dirichlet(alpha, size=(B * K,))).astype(np.float32)
        _, sub = jax.random.split(jstate.rng)
        g = np.asarray(jax.random.gumbel(sub, (B, K * Vv), jnp.float32))
        # the cache rows hold their own index, so the gather by origin shows
        prev = tstate._replace(cache=ids_cache)
        jstate = jstep(jstate, jnp.asarray(logp))
        tstate = tbeam.beam_select_step(prev, _t(logp), tctx, _t(g))
        assert tstate.cur_len == int(jstate.cur_len) == t + 1
        for name in ("seqs", "fin_seqs", "fin_count", "done", "fin_lens"):
            np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                          np.asarray(getattr(jstate, name)), err_msg=name)
        for name in ("beam_scores", "fin_scores"):
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       np.asarray(getattr(jstate, name)), **SCORES,
                                       err_msg=name)
        # the new cache row of a beam is the old row of its origin beam
        origin = tstate.cache.k[0, :, 0, 0, 0].long()
        live = ~prev.done.repeat_interleave(K)
        np.testing.assert_array_equal(
            tstate.seqs.reshape(B * K, -1)[live, :t].numpy(),
            prev.seqs.reshape(B * K, -1)[origin][live, :t].numpy())
    assert bool(tstate.done.any())


class _RefBeamHypotheses:
    """Numpy transcription of BeamHypotheses (v10.py:1794-1839), as in
    tests/test_generation.py."""

    def __init__(self, num_beams, length_penalty):
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.beams = []
        self.worst_score = 1e9

    def __len__(self):
        return len(self.beams)

    def add(self, hyp_len, sum_logprobs):
        score = sum_logprobs / (hyp_len ** self.length_penalty)
        if len(self) < self.num_beams or score > self.worst_score:
            self.beams.append(score)
            if len(self) > self.num_beams:
                srt = sorted((s, i) for i, s in enumerate(self.beams))
                del self.beams[srt[0][1]]
                self.worst_score = srt[1][0]
            else:
                self.worst_score = min(score, self.worst_score)

    def is_done(self, best_sum_logprobs, cur_len):
        if len(self) < self.num_beams:
            return False
        return self.worst_score >= best_sum_logprobs / (cur_len ** self.length_penalty)


def test_selection_matches_the_process_transcription():
    """tests/test_generation.py::TestBeamScorerOracle run against the port:
    a per-example walk of ``BeamSearchScorer_constrained.process`` over the
    same candidate draw (its own noise, from a torch generator) gives the
    port's tokens, origins, boosted scores, hypothesis pools and done flags."""
    B, K, Vv, Lp, steps = 2, 3, 12, 4, 4
    eos_id, lp, factor = 1, 1.0, 0.5
    prompt_len = np.array([4, 3])
    cmask = np.zeros((B, Vv), bool)
    cmask[0, 7] = cmask[0, 8] = True
    _, ctx, _, state = _contexts(B, K, Vv, Lp, steps, prompt_len, cmask, eos_id=eos_id,
                                 constraint_factor=factor, repetition_penalty=1.0, top_k=0,
                                 length_penalty=lp)
    hyps = [_RefBeamHypotheses(K, lp) for _ in range(B)]
    o_scores = np.zeros((B, K))
    o_done = [False] * B
    script = np.random.default_rng(9)
    gen = torch.Generator().manual_seed(3)
    for t in range(steps):
        logp = np.log(script.dirichlet(np.ones(Vv), size=(B * K,))).astype(np.float32)
        g = tbeam.gumbel_noise((B, K * Vv), gen, "cpu")
        prev = state
        state = tbeam.beam_select_step(state, _t(logp), ctx, g)

        flat = (logp + o_scores.reshape(-1)[:, None].astype(np.float32)).reshape(B, K * Vv)
        top = np.argsort(-(flat + g.numpy()), axis=1, kind="stable")[:, :2 * K]
        cand = np.take_along_axis(flat, top, axis=1)
        order = np.argsort(-cand, axis=1, kind="stable")
        top, cand = np.take_along_axis(top, order, 1), np.take_along_axis(cand, order, 1)
        for b in range(B):
            if o_done[b]:
                continue
            cur_len, slot = int(prompt_len[b]) + t, 0
            sel = []
            for r in range(2 * K):
                tok, sc, org = int(top[b, r] % Vv), float(cand[b, r]), int(top[b, r] // Vv)
                if tok == eos_id:
                    if r < K:
                        hyps[b].add(cur_len, sc)
                else:
                    sel.append((tok, org, sc * factor if cmask[b, tok] else sc))
                    slot += 1
                if slot == K:
                    break
            o_done[b] = hyps[b].is_done(float(cand[b].max()), cur_len)
            np.testing.assert_array_equal(state.seqs[b, :, t].numpy(), [s[0] for s in sel])
            np.testing.assert_array_equal(state.seqs[b, :, :t].numpy(),
                                          prev.seqs[b, [s[1] for s in sel], :t].numpy())
            np.testing.assert_allclose(state.beam_scores[b].numpy(), [s[2] for s in sel],
                                       rtol=1e-5, atol=1e-6)
            o_scores[b] = [s[2] for s in sel]
        np.testing.assert_array_equal(state.done.numpy(), o_done)
        for b in range(B):
            kept = sorted(s for s in state.fin_scores[b].tolist() if s > -1e8)
            np.testing.assert_allclose(kept, sorted(hyps[b].beams), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ the decode

@pytest.fixture(scope="module")
def gpt2():
    """The JAX decoder (tied head) and the port's with its weights; a
    prompt, a memory with a masked tail in row 1."""
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


CASES = {
    # max_steps reached, nothing finished
    "no-eos": dict(num_beams=3, max_steps=6, eos_id=1, top_k=20, repetition_penalty=1.0,
                   constraint=False, plen=(6, 6)),
    # an eos that the beams emit: hypotheses finish, batches stop early;
    # a right-padded prompt, constraints boosted, repeats penalized
    "eos-padded-constrained": dict(num_beams=4, max_steps=10, eos_id=43, top_k=0,
                                   repetition_penalty=1.3, constraint=True, plen=(6, 4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_constrained_beam_sample_equals_jax_with_replayed_noise(gpt2, case):
    kw = dict(CASES[case])
    constraint, plen = kw.pop("constraint"), np.asarray(kw.pop("plen"), np.int32)
    B, K = gpt2["prompt"].shape[0], kw["num_beams"]
    cmask = np.zeros((B, V), bool)
    if constraint:
        cmask[:, 40:60] = True
    key = jax.random.PRNGKey(11)
    want_t, want_l = jax.jit(
        lambda p, prompt, pl, mem, mm, cm: jbeam.constrained_beam_sample(
            gpt2["j"], p, prompt, pl, memory=mem, memory_mask=mm, rng=key, pad_id=0,
            constraint_mask=cm, constraint_factor=0.8, **kw))(
        gpt2["params"], jnp.asarray(gpt2["prompt"]), jnp.asarray(plen),
        jnp.asarray(gpt2["mem"]), jnp.asarray(gpt2["mmask"]), jnp.asarray(cmask))
    noise = jax_gumbel(key, kw["max_steps"], (B, K * V))
    got_t, got_l = tbeam.constrained_beam_sample(
        gpt2["t"], _t(gpt2["prompt"]), _t(plen), memory=_t(gpt2["mem"]),
        memory_mask=_t(gpt2["mmask"]), noise=_t(noise), pad_id=0,
        constraint_mask=_t(cmask), constraint_factor=0.8, **kw)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    if case != "no-eos":
        assert (got_l.numpy() < kw["max_steps"]).any()


def test_generate_beam_dispatch_and_refusals(gpt2):
    prompt, plen = _t(gpt2["prompt"]).long(), torch.as_tensor([6, 4])
    kw = dict(memory=_t(gpt2["mem"]), memory_mask=_t(gpt2["mmask"]), eos_id=84)
    got = generate(gpt2["t"], prompt, plen, mode="beam", max_len=5, num_beams=3,
                   generator=torch.Generator().manual_seed(4), **kw)
    want = tbeam.constrained_beam_sample(gpt2["t"], prompt, plen, max_steps=5, num_beams=3,
                                         top_k=50, generator=torch.Generator().manual_seed(4),
                                         **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (2, 5) and got[1].shape == (2,)
    with pytest.raises(ValueError, match="mode='beam' requires"):
        generate(gpt2["t"], prompt, plen, mode="beam", **kw)
    with pytest.raises(ValueError, match="Generator or the noise"):
        tbeam.constrained_beam_sample(gpt2["t"], prompt, plen, **kw)


# ------------------------------------------------------------ constraints

def test_attention_constraints_equal_jax():
    tokens = [["[CLS]", "the", "dog", "##gy", "is", "running", "<|det3|>", "[SEP]", "Dog",
               "park", "!", "</s>", "ran"],
              ["<s>", "a", "cat", "sat", "on", "mats", "cat", "[PAD]", "x", "y", "z", "w",
               "v"]]
    attn = np.random.default_rng(4).random((2, 13)).astype(np.float32)
    attn[0, :3] = [9.0, 8.0, 7.0]
    encode = lambda s: [sum(map(ord, s)) % 50, len(s), 77]
    for toks, a in zip(tokens, attn):
        for n in (1, 3, 5):
            assert tcons.extract_constraint_words(toks, a, max_constraints=n) == \
                jcons.extract_constraint_words(toks, a, max_constraints=n)
        assert tcons.extract_constraint_words(toks, a, extra_stopwords=["dog"]) == \
            jcons.extract_constraint_words(toks, a, extra_stopwords=["dog"])
    np.testing.assert_array_equal(tcons.extract_constraints(tokens, attn, encode, 60),
                                  jcons.extract_constraints(tokens, attn, encode, 60))
    assert tcons.STOPWORDS == jcons.STOPWORDS
