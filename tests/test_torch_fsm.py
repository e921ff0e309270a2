"""PyTorch port, FSM-constrained beam search and the box-driven constraint
front end: ``generation/{fsm,box_constraints}.py`` and
``generate(mode="cbs")``, held against the JAX package on the CPU with the
same numpy inputs and GPT-2 weights (``gpt2_params_from_jax``).

Tolerances: adjacency tensors bit-equal; lattice tokens identical, their
log-probs within 1e-5 (fp32: the two frameworks' log-softmax), including a
uniform language model where every candidate ties; selections, lengths and
the front end's outputs exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.core.config import GPT2Config as JGPT2
from multimodal_context_reasoning_tpu.generation import box_constraints as jbox
from multimodal_context_reasoning_tpu.generation import fsm as jfsm
from multimodal_context_reasoning_tpu.generation.api import generate as jgenerate
from multimodal_context_reasoning_tpu.models.gpt2 import GPT2Decoder as JDecoder
from multimodal_context_reasoning_torch.core.config import GPT2Config as TGPT2
from multimodal_context_reasoning_torch.generation import box_constraints as tbox
from multimodal_context_reasoning_torch.generation import fsm as tfsm
from multimodal_context_reasoning_torch.generation.api import generate
from multimodal_context_reasoning_torch.interop.from_jax import gpt2_params_from_jax
from multimodal_context_reasoning_torch.models.gpt2 import GPT2Decoder

V = 16
EOS = 1
LOGP = dict(rtol=1e-5, atol=1e-5)
CONSTRAINTS = {
    "one-word": [[[5, 6]]],
    "multi-word": [[[3], [4]]],
    "self-loop-quirk": [[[5]], [[7]]],
    "three": [[[5, 6]], [[7]], [[3], [4], [9]]],
}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", list(CONSTRAINTS))
def test_adjacency_bit_equal_to_jax(name):
    for given, words in ((3, 3), (2, 2)):
        if len(CONSTRAINTS[name]) > given:
            continue
        want = jfsm.FiniteStateMachineBuilder(V, given, words).build(CONSTRAINTS[name])
        got = tfsm.FiniteStateMachineBuilder(V, given, words).build(CONSTRAINTS[name])
        assert got.adjacency.dtype == want.adjacency.dtype
        np.testing.assert_array_equal(got.adjacency, want.adjacency)
        assert (got.num_main_states, got.substate_end) == (want.num_main_states,
                                                           want.substate_end)


def _lattices(sets, given=3, words=2):
    jb = jfsm.FiniteStateMachineBuilder(V, given, words)
    return np.stack([jb.build(c).adjacency for c in sets])


@pytest.mark.parametrize("lm", ["scripted", "uniform"])
def test_fsm_beam_search_equals_jax(lm):
    """A scripted step distribution that depends on (t, last token), and a
    uniform one where every candidate of a state ties; a carry that tags
    each row, so the reorder by backpointers shows."""
    B, K, max_steps = 2, 5, 8
    rng = np.random.default_rng(7)
    adjacency = _lattices([[[[5, 6]], [[7]], [[3], [4]]], [[[9]], [[2], [8]]]])
    S = adjacency.shape[1]
    if lm == "scripted":
        table = np.log(rng.dirichlet(np.ones(V), size=(max_steps, V))).astype(np.float32)
        init = np.log(rng.dirichlet(np.ones(V), size=(B,))).astype(np.float32)
    else:
        table = np.full((max_steps, V, V), np.log(1.0 / V), np.float32)
        init = np.full((B, V), np.log(1.0 / V), np.float32)

    jbeams, jlp = jfsm.fsm_beam_search(
        jnp.asarray(init), lambda tok, c, t: (jnp.asarray(table)[t][tok], c + 1),
        jnp.arange(B * S * K) * 100, lambda c, rows: c[rows], jnp.asarray(adjacency),
        num_beams=K, max_steps=max_steps, eos_ids=(EOS,), implementation="unrolled")
    tags = []
    beams, lp = tfsm.fsm_beam_search(
        _t(init), lambda tok, c, t: (_t(table)[t][tok], c + 1),
        torch.arange(B * S * K) * 100, lambda c, rows: tags.append(rows) or c[rows],
        _t(adjacency), num_beams=K, max_steps=max_steps, eos_ids=(EOS,))
    np.testing.assert_array_equal(beams.numpy(), np.asarray(jbeams))
    finite = np.isfinite(np.asarray(jlp))
    np.testing.assert_array_equal(np.isfinite(lp.numpy()), finite)
    np.testing.assert_allclose(lp.numpy()[finite], np.asarray(jlp)[finite], **LOGP)
    assert len(tags) == max_steps - 2


def test_select_best_beam_equals_jax():
    rng = np.random.default_rng(3)
    B, S, K, T = 3, 8, 2, 6
    beams = rng.integers(0, V, size=(B, S, K, T)).astype(np.int32)
    beams[..., -2:] = EOS
    lp = rng.normal(-5, 2, size=(B, S, K)).astype(np.float32)
    lp[0, 3] = -np.inf
    given = np.asarray([3, 1, 0], np.int32)
    for need in (0, 1, 2, 3):
        jb, jl = jfsm.select_best_beam_with_constraints(
            jnp.asarray(beams), jnp.asarray(lp), jnp.asarray(given), need, (EOS, 9))
        tb, tl = tfsm.select_best_beam_with_constraints(_t(beams), _t(lp), _t(given), need,
                                                         (EOS, 9))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.fixture(scope="module")
def decoder():
    """A GPT-2 with cross-attention over a memory (row 1's tail masked): the
    port shares one projected memory among each question's S·K rows."""
    kw = dict(vocab_size=V, n_positions=64, n_embd=16, n_layer=1, n_head=2, resid_pdrop=0.0,
              embd_pdrop=0.0, attn_pdrop=0.0, pad_token_id=0)
    jmodel = JDecoder(JGPT2(**kw))
    rng = np.random.default_rng(1)
    B, Lp, M = 2, 3, 4
    prompt = rng.integers(2, V, size=(B, Lp)).astype(np.int32)
    mem = rng.normal(size=(B, M, 16)).astype(np.float32)
    mmask = np.ones((B, M), np.float32)
    mmask[1, 2:] = 0.0
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(prompt), memory=jnp.asarray(mem),
                         memory_mask=jnp.asarray(mmask))
    tmodel = GPT2Decoder(TGPT2(**kw)).eval()
    tmodel.load_state_dict(gpt2_params_from_jax(jax.tree.map(np.asarray, params), 1))
    adjacency = _lattices([[[[5]], [[7]]], [[[3], [4]], [[9]]]], given=2, words=2)
    return dict(j=jmodel, params=params, t=tmodel, prompt=prompt, plen=np.asarray([3, 2]),
                mem=mem, mmask=mmask, adjacency=adjacency)


def test_fsm_decode_gpt2_equals_jax(decoder):
    d = decoder
    jbeams, jlp = jax.jit(lambda p, *a: jfsm.fsm_decode_gpt2(
        d["j"], p, *a[:3], memory=a[3], memory_mask=a[4], num_beams=3, max_steps=7,
        eos_ids=(EOS,)))(d["params"], jnp.asarray(d["prompt"]), jnp.asarray(d["plen"]),
                         jnp.asarray(d["adjacency"]), jnp.asarray(d["mem"]),
                         jnp.asarray(d["mmask"]))
    beams, lp = tfsm.fsm_decode_gpt2(d["t"], _t(d["prompt"]), _t(d["plen"]),
                                     _t(d["adjacency"]), memory=_t(d["mem"]),
                                     memory_mask=_t(d["mmask"]), num_beams=3, max_steps=7,
                                     eos_ids=(EOS,))
    np.testing.assert_array_equal(beams.numpy(), np.asarray(jbeams))
    finite = np.isfinite(np.asarray(jlp))
    np.testing.assert_allclose(lp.numpy()[finite], np.asarray(jlp)[finite], **LOGP)


def test_generate_cbs_equals_jax_and_refuses_like_it(decoder):
    d = decoder
    kw = dict(mode="cbs", min_constraints_to_satisfy=1, num_beams=3, max_len=7, eos_id=EOS)
    n = np.asarray([2, 2], np.int32)
    jt, jl = jgenerate(d["j"], d["params"], jnp.asarray(d["prompt"]), jnp.asarray(d["plen"]),
                       memory=jnp.asarray(d["mem"]), memory_mask=jnp.asarray(d["mmask"]),
                       fsm_adjacency=jnp.asarray(d["adjacency"]),
                       num_constraints=jnp.asarray(n), **kw)
    tt, tl = generate(d["t"], _t(d["prompt"]), _t(d["plen"]), memory=_t(d["mem"]),
                      memory_mask=_t(d["mmask"]), fsm_adjacency=_t(d["adjacency"]),
                      num_constraints=_t(n), **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    prompt, plen = _t(d["prompt"]), _t(d["plen"])
    with pytest.raises(ValueError, match="fsm_adjacency"):
        generate(d["t"], prompt, plen, mode="cbs")
    with pytest.raises(ValueError, match="num_constraints"):
        generate(d["t"], prompt, plen, mode="cbs", fsm_adjacency=_t(d["adjacency"]))


# ------------------------------------------------------------ front end

HIERARCHY = {
    "LabelName": "entity",
    "Subcategory": [
        {"LabelName": "animal", "Subcategory": [
            {"LabelName": "carnivore", "Subcategory": [{"LabelName": "dog"}]},
            {"LabelName": "cat"},
        ]},
        {"LabelName": "food", "Subcategory": [{"LabelName": "sandwich"}]},
        {"LabelName": "band-aid"},
    ],
}


def test_box_front_end_equals_jax(tmp_path):
    """Readers, hierarchy, filter (blacklist, zero scores, NMS, top-k,
    replacements, dedup) and tokenization give the JAX outputs."""
    (tmp_path / "forms.tsv").write_text("dog\tdog,dogs\ncat\tcat,cats,kitty\n")
    rows = {"img1": [{"rect": [0, 0, 10, 10], "class": "Dog", "conf": 0.9},
                     {"rect": [1, 1, 11, 11], "class": "Band-Aid", "conf": 0.7}],
            "img2": []}
    (tmp_path / "boxes.tsv").write_text(
        "".join(f"{k}\t{json.dumps(v)}\n" for k, v in rows.items()))
    assert tbox.load_wordforms(str(tmp_path / "forms.tsv")) == \
        jbox.load_wordforms(str(tmp_path / "forms.tsv"))
    treader = tbox.ConstraintBoxesReader(str(tmp_path / "boxes.tsv"))
    jreader = jbox.ConstraintBoxesReader(str(tmp_path / "boxes.tsv"))
    assert len(treader) == len(jreader)
    for key in ("img1", "img2", "missing"):
        a, b = treader[key], jreader[key]
        assert a["class_names"] == b["class_names"]
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["scores"], b["scores"])

    th, jh = tbox.ClassHierarchy(HIERARCHY), jbox.ClassHierarchy(HIERARCHY)
    for name in ("dog", "cat", "carnivore", "hotdog", "sandwich", "entity"):
        assert th.height(name) == jh.height(name)
    with pytest.raises(IndexError):
        th.height("zebra")

    vocab = {"dog": 3, "dogs": 4, "cat": 5, "cats": 6, "kitty": 7, "sandwich": 8,
             "bandaid": 9, "hot": 10}
    conv = lambda toks: [vocab[t] for t in toks]
    rng = np.random.default_rng(0)
    names = ["dog", "cat", "person", "sandwich", "band-aid", "dog", "tree", "cat"]
    boxes = rng.integers(0, 50, size=(8, 2)).astype(float)
    boxes = np.concatenate([boxes, boxes + rng.integers(1, 20, size=(8, 2))], axis=1)
    scores = np.asarray([0.9, 0.8, 0.99, 0.0, 0.7, 0.6, 0.95, 0.85])
    for k in (1, 2, 3):
        tf = tbox.ConstraintFilter(th, 0.85, k)
        jf = jbox.ConstraintFilter(jh, 0.85, k)
        assert tf(boxes, names, scores) == jf(boxes, names, scores)
        kw = dict(wordforms={"dog": ["dog", "dogs"], "cat": ["cat", "cats", "kitty"]},
                  constraint2tokens={"band-aid": ["bandaid"]}, max_words_per_constraint=2)
        assert tbox.boxes_to_constraint_ids(boxes, names, scores, tf, conv, **kw) == \
            jbox.boxes_to_constraint_ids(boxes, names, scores, jf, conv, **kw)
    assert tbox.tokenize_constraints(["hot dog sandwich"], conv, max_words_per_constraint=2) \
        == jbox.tokenize_constraints(["hot dog sandwich"], conv, max_words_per_constraint=2)
    assert tbox.BLACKLIST == jbox.BLACKLIST and tbox.REPLACEMENTS == jbox.REPLACEMENTS
