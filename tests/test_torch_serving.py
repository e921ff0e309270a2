"""PyTorch port, the serve command: ``serving/batcher.py``,
``serving/server.py`` and ``cli/serve.py`` held against the JAX package's at
``ModCRConfig.tiny()``, fp32, on the CPU, with the same weights carried
across by ``interop/from_jax.py::params_from_jax``.

Replies are compared as the scorers are (tests/test_torch_scorer.py):
logits and probabilities within 2e-4, predictions and ids equal.  The
back-pressure tests gate a stub scorer with a ``threading.Event`` instead of
sleeping, so each request's state (in the forward, queued, shed) is known
when the next one is sent; every blocking call has a timeout.
"""

import json
import pickle
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_context_reasoning_tpu.cli import serve as jserve_cli
from multimodal_context_reasoning_tpu.core.config import ChunkAlignConfig as JSched
from multimodal_context_reasoning_tpu.core.config import EncoderConfig as JEnc
from multimodal_context_reasoning_tpu.core.config import GPT2Config as JGPT2
from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.data import schemas as jschemas
from multimodal_context_reasoning_tpu.data import tokenization as jtok
from multimodal_context_reasoning_tpu.interop.export import export_rationale_state_dict
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
from multimodal_context_reasoning_tpu.models.rationale import RationaleModel as JRationale
from multimodal_context_reasoning_tpu.models.rationale import rationale_init_batch
from multimodal_context_reasoning_tpu.serving.scorer import ModCRScorer as JScorer
from multimodal_context_reasoning_tpu.serving.server import serve as jserve
from multimodal_context_reasoning_torch.cli import serve as tserve_cli
from multimodal_context_reasoning_torch.core.config import ModCRConfig as TConfig
from multimodal_context_reasoning_torch.data import schemas as tschemas
from multimodal_context_reasoning_torch.data import tokenization as ttok
from multimodal_context_reasoning_torch.interop.from_jax import params_from_jax
from multimodal_context_reasoning_torch.models.modcr import ModCRModel as TModel
from multimodal_context_reasoning_torch.serving.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Overloaded,
)
from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer as TScorer
from multimodal_context_reasoning_torch.serving.server import serve as tserve
from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager, save_config
from tests.test_torch_models import make_batch

TOL = dict(rtol=2e-4, atol=2e-4)
WAIT = 10.0   # seconds: the bound of every blocking call in this file
CHOICES = ["they hug .", "they fight .", "they leave .", "they sing ."]


def _features(schemas, dim, seed=0):
    rng = np.random.default_rng(seed)
    return {f"img-{i}": schemas.ImageFeatures(
        features=rng.normal(size=(3 + i, dim)).astype(np.float32), num_regions=3 + i)
        for i in range(4)}


def _example(schemas, i):
    # short texts: the tiny geometry keeps 16 BERT and 20 RoBERTa tokens
    return schemas.RawExample(
        example_id=f"e{i}", img_id=f"img-{i % 4}", premise=f"friend {i} waits .",
        answer_choices=CHOICES[i % 4:] + CHOICES[:i % 4], answer_label=None)


def _body(ids, **extra):
    return {"examples": [{"example_id": f"e{i}", "img_id": f"img-{i % 4}",
                          "premise": f"friend {i} waits .",
                          "answer_choices": CHOICES[i % 4:] + CHOICES[:i % 4]}
                         for i in ids], **extra}


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's scorer on the same tiny fp32 weights."""
    jcfg, tcfg = JConfig.tiny(), TConfig.tiny()
    dim = jcfg.global_encoder.img_feature_dim
    params = jax.tree.map(np.asarray, jax.jit(JModel(jcfg).init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in make_batch(jcfg).items()}))
    vocab = dict(vocab_size=jcfg.global_encoder.vocab_size)
    rob = dict(vocab_size=jcfg.roberta.vocab_size)
    jscorer = JScorer(jcfg, params, jtok.HashTokenizer(**vocab),
                      jtok.RobertaHashTokenizer(**rob), _features(jschemas, dim),
                      micro_batch=2)
    tscorer = TScorer(tcfg, params_from_jax(params, tcfg), ttok.HashTokenizer(**vocab),
                      ttok.RobertaHashTokenizer(**rob), _features(tschemas, dim),
                      micro_batch=2, device="cpu")
    return dict(j=jscorer, t=tscorer, params=params)


def _request(port, path, body=None, timeout=WAIT):
    """(status, JSON body, Retry-After header) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r), r.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), e.headers.get("Retry-After")


def _keys(tree):
    """The nested key structure of a JSON object."""
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in tree.items()}


@pytest.fixture
def servers(pair, request):
    batching = getattr(request, "param", True)
    both = {side: serve_fn(pair[side], port=0, block=False, batching=batching)
            for side, serve_fn in (("j", jserve), ("t", tserve))}
    yield {side: s.server_address[1] for side, s in both.items()}
    for s in both.values():
        s.modcr_close()


def _assert_same_results(got, want):
    assert [r["example_id"] for r in got] == [r["example_id"] for r in want]
    assert [r["prediction"] for r in got] == [r["prediction"] for r in want]
    np.testing.assert_allclose([r["logits"] for r in got], [r["logits"] for r in want], **TOL)
    np.testing.assert_allclose([r["probs"] for r in got], [r["probs"] for r in want], **TOL)


# ---------------------------------------------------------------- the server

@pytest.mark.parametrize("servers", [True, False], indirect=True,
                         ids=["batching", "one lock"])
def test_score_replies_health_and_stats_match_the_jax_server(servers):
    for ids in ([0], [1, 2, 3], [3, 0, 1, 2, 1]):
        (jc, jout, _), (tc, tout, _) = (_request(servers[s], "/score", _body(ids))
                                        for s in ("j", "t"))
        assert jc == tc == 200
        _assert_same_results(tout["results"], jout["results"])
        assert np.ptp(tout["results"][0]["logits"]) > 1e-4   # candidates differ
    health = [_request(servers[s], "/healthz") for s in ("j", "t")]
    assert health[0][:2] == health[1][:2] == (200, {"status": "ok"})
    (_, jstats, _), (_, tstats, _) = (_request(servers[s], "/stats") for s in ("j", "t"))
    assert _keys(tstats) == _keys(jstats)
    for key in ("requests", "examples", "errors"):
        assert tstats[key] == jstats[key]
    assert tstats["requests"] == 3 and tstats["examples"] == 9


ERRORS = {
    "no examples": ("/score", {}),
    "empty list": ("/score", {"examples": []}),
    "missing field": ("/score", {"examples": [{"example_id": "x", "premise": "p .",
                                               "answer_choices": CHOICES}]}),
    "no generator": ("/generate", _body([0])),
    "unknown path": ("/rank", _body([0])),
    "bad answer_choices": ("/score", {"examples": [{"img_id": "img-0", "premise": "p .",
                                                    "answer_choices": 4}]}),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_error_replies_match_the_jax_server(servers, case):
    """400 (no examples, a missing field), 404 (/generate without a
    generator, an unknown path) and 500 (the exception's type): the same
    status and body."""
    path, body = ERRORS[case]
    (jc, jout, _), (tc, tout, _) = (_request(servers[s], path, body) for s in ("j", "t"))
    assert tc == jc and tout == jout
    assert tc in (400, 404, 500)


# ---------------------------------------------------------------- /generate

def _rationale_pth(path, seed=3):
    """A reference-layout rationale .pth: the JAX tiny family (the JAX serve
    command's --tiny geometry) at a random init, exported."""
    enc = JEnc(vocab_size=256, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
               intermediate_size=64, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, max_position_embeddings=128,
               img_feature_dim=20)
    gpt = JGPT2(vocab_size=128, n_positions=128, n_embd=32, n_layer=2, n_head=4,
                resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, pad_token_id=0)
    model = JRationale(enc, JSched(chunk_layers_end=1, full_layers_end=2), gpt, max_chunks=8)
    init = rationale_init_batch(enc, gpt, JConfig.tiny())
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 {k: jnp.asarray(v) for k, v in init.items()})
    sd = export_rationale_state_dict(jax.tree.map(np.asarray, params), enc, gpt)
    torch.save({"net": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    return str(path)


@pytest.fixture(scope="module")
def gen_cli(cli_files, tmp_path_factory):
    """Both serve commands with --generate from one reference rationale .pth,
    --tiny, fp32 (the encoders' compute dtype of the tiny family follows
    --compute_dtype), greedy; what each passed to serve()."""
    from multimodal_context_reasoning_tpu.serving import server as jserver
    from multimodal_context_reasoning_torch.serving import server as tserver

    pth = _rationale_pth(tmp_path_factory.mktemp("gen_cli") / "rationale.pth")
    argv = ["--img_feat_file", cli_files["pkl"], "--tiny", "--compute_dtype", "float32",
            "--micro_batch", "2", "--generate", "--rationale_ckpt", pth,
            "--gen_micro_batch", "2", "--max_rationale_len", "8"]
    with pytest.MonkeyPatch.context() as mp:
        jcap = _capture(mp, jserver)
        jserve_cli.main(argv)
        tcap = _capture(mp, tserver)
        tserve_cli.main(argv + ["--device", "cpu"])
    return dict(j=jcap, t=tcap)


def _assert_same_generations(got, want):
    for key in ("example_id", "prediction", "rationale_ids"):
        assert [r[key] for r in got] == [r[key] for r in want], key
    np.testing.assert_allclose([r["probs"] for r in got], [r["probs"] for r in want], **TOL)
    assert all("rationale_text" not in r for r in got + want)   # hash tokenizers


def test_serve_cli_generates_as_the_jax_cli_from_a_reference_checkpoint(gen_cli):
    """serve --generate --rationale_ckpt: the same generator replies as the
    JAX command from the same .pth (greedy)."""
    jgen, tgen = gen_cli["j"]["generator"], gen_cli["t"]["generator"]
    ids = [0, 1, 2, 3, 5]
    want = jgen.generate([_example(jschemas, i) for i in ids])
    got = tgen.generate([_example(tschemas, i) for i in ids])
    _assert_same_generations(got, want)
    assert len({tuple(r["rationale_ids"]) for r in got}) > 1
    assert tgen.micro_batch == 2 and tgen.max_rationale_len == 8


@pytest.mark.parametrize("batching", [True, False], ids=["batching", "one lock"])
def test_generate_replies_and_stats_match_the_jax_server(gen_cli, batching):
    both = {side: serve_fn(gen_cli[side]["scorer"], port=0, block=False, batching=batching,
                           generator=gen_cli[side]["generator"])
            for side, serve_fn in (("j", jserve), ("t", tserve))}
    try:
        ports = {side: s.server_address[1] for side, s in both.items()}
        for ids in ([0], [1, 2, 3]):
            (jc, jout, _), (tc, tout, _) = (_request(ports[s], "/generate", _body(ids))
                                            for s in ("j", "t"))
            assert jc == tc == 200
            _assert_same_generations(tout["results"], jout["results"])
        (jc, jout, _), (tc, tout, _) = (_request(ports[s], "/score", _body([2]))
                                        for s in ("j", "t"))
        assert jc == tc == 200 and len(tout["results"]) == 1
        (_, jstats, _), (_, tstats, _) = (_request(ports[s], "/stats") for s in ("j", "t"))
    finally:
        for s in both.values():
            s.modcr_close()
    assert _keys(tstats) == _keys(jstats)
    assert tstats["requests"] == jstats["requests"] == 3 and tstats["examples"] == 5
    for key in ("requests", "examples"):
        assert tstats["routes"]["generate"][key] == jstats["routes"]["generate"][key]
    if batching:
        assert (tstats["routes"]["generate"]["device_dispatches"]
                == jstats["routes"]["generate"]["device_dispatches"] == 3)


def test_sampling_generator_repeats_under_a_seed(gen_cli):
    """mode="sample": a seeded torch.Generator repeats its replies; without
    one every call draws from a fresh seed."""
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator

    tgen = gen_cli["t"]["generator"]
    sampler = RationaleGenerator(
        tgen.encoder_config, tgen.model.seq_enc.schedule, tgen.gpt2_config, tgen.model,
        ttok.HashTokenizer(vocab_size=256), tgen.gpt_tokenizer, tgen.features,
        spec=tgen.spec, max_chunks=8, micro_batch=2, max_rationale_len=8, mode="sample",
        device="cpu")
    exs = [_example(tschemas, i) for i in (0, 1, 2)]
    a, b = (sampler.generate(exs, generator=torch.Generator().manual_seed(7))
            for _ in range(2))
    assert [r["rationale_ids"] for r in a] == [r["rationale_ids"] for r in b]
    assert [r["probs"] for r in a] == [r["probs"] for r in tgen.generate(exs)]
    free = [sampler.generate(exs) for _ in range(2)]
    assert free[0] != free[1]


def test_generator_refuses_marker_ids_outside_the_vocabulary(gen_cli):
    from multimodal_context_reasoning_torch.core.config import GPT2Config as TGPT2
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator

    tgen = gen_cli["t"]["generator"]
    args = (tgen.encoder_config, tgen.model.seq_enc.schedule)
    rest = dict(spec=tgen.spec, max_chunks=8, device="cpu", warm=False)
    small = types.SimpleNamespace(convert_tokens_to_ids=lambda toks: [200, 201])
    with pytest.raises(ValueError, match="fall outside GPT2Config.vocab_size=128"):
        RationaleGenerator(*args, tgen.gpt2_config, tgen.model, None, small, {}, **rest)
    same = types.SimpleNamespace(convert_tokens_to_ids=lambda toks: [3, 3])
    with pytest.raises(ValueError, match="map to the same id 3"):
        RationaleGenerator(*args, tgen.gpt2_config, tgen.model, None, same, {}, **rest)
    short = TGPT2(**{**tgen.gpt2_config.__dict__, "n_positions": 8})
    with pytest.raises(ValueError, match="max_rationale_len=8 needs 9 positions"):
        RationaleGenerator(*args, short, tgen.model, None, tgen.gpt_tokenizer, {},
                           max_rationale_len=8, **rest)


def test_a_burst_of_concurrent_connections_is_served():
    """32 clients connecting at once, more than the standard library's
    listen backlog of 5, with the interpreter switching threads 50 times as
    often as by default: every one gets its own reply, and the server's
    counters lose no update."""
    stub = GatedStub(gated=False)
    stub.micro_batch = 4
    server = tserve(stub, port=0, block=False, max_wait_ms=1.0)
    port = server.server_address[1]
    barrier, replies = threading.Barrier(32), {}

    def client(i):
        barrier.wait(timeout=WAIT)
        replies[i] = _request(port, "/score", _body([i, i + 32]))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(interval / 50)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        for i, (code, body, _) in replies.items():
            assert code == 200
            assert [r["example_id"] for r in body["results"]] == [f"e{i}", f"e{i + 32}"]
        stats = _request(port, "/stats")[1]
        assert (stats["requests"], stats["examples"]) == (32, 64)
        assert sum(server.modcr_batcher.telemetry()) == 64
    finally:
        sys.setswitchinterval(interval)
        server.modcr_close()


def test_modcr_close_tears_down_the_batcher(pair):
    server = tserve(pair["t"], port=0, block=False)
    assert _request(server.server_address[1], "/healthz")[0] == 200
    b = server.modcr_batcher
    assert b is not None and b._thread.is_alive()
    server.modcr_close()
    b._thread.join(timeout=WAIT)
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        b.score([_example(tschemas, 0)])


# ---------------------------------------------------------------- the batcher

def test_concurrent_clients_coalesce_and_match_direct_scoring(pair):
    """8 one-example requests from 8 threads through the port's batcher:
    fewer forwards than requests, and each client gets what direct scoring
    gives."""
    scorer = pair["t"]
    batcher = MicroBatcher(scorer, max_wait_ms=200.0)
    try:
        examples = [_example(tschemas, i) for i in range(8)]
        want = {r["example_id"]: r for r in scorer.score(examples)}
        results, errs = {}, []
        barrier = threading.Barrier(8)

        def client(ex):
            try:
                barrier.wait(timeout=WAIT)
                results[ex.example_id] = batcher.score([ex])[0]
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(ex,)) for ex in examples]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not errs, errs
        assert set(results) == set(want)
        _assert_same_results([results[k] for k in sorted(want)],
                             [want[k] for k in sorted(want)])
        sizes = batcher.telemetry()
        assert sum(sizes) == 8 and len(sizes) < 8 and max(sizes) == scorer.micro_batch
    finally:
        batcher.close()


def test_lone_request_is_one_forward(pair):
    batcher = MicroBatcher(pair["t"], max_wait_ms=5.0)
    try:
        assert batcher.score([_example(tschemas, 0)])[0]["example_id"] == "e0"
        assert batcher.telemetry() == [1]
    finally:
        batcher.close()


class GatedStub:
    """A duck-typed scorer whose forward blocks until ``release`` is set:
    ``entered`` tells the test that the dispatcher is inside it."""

    micro_batch = 1

    def __init__(self, gated: bool = True):
        self.entered, self.release = threading.Event(), threading.Event()
        if not gated:
            self.release.set()

    def featurize(self, ex):
        return {"id": ex.example_id}

    def score_featurized(self, feats, ids):
        self.entered.set()
        assert self.release.wait(timeout=WAIT)
        return [{"example_id": i, "prediction": 0, "logits": [0.0] * 4,
                 "probs": [0.25] * 4} for i in ids]


def test_close_fails_stragglers_instead_of_hanging():
    """An item queued behind close()'s sentinel gets its future failed by
    the dispatcher's drain, not left blocking its client."""
    stub = GatedStub()
    batcher = MicroBatcher(stub, max_wait_ms=5.0)
    first, straggler = Future(), Future()
    batcher._q.put(({}, "first", first, None))
    assert stub.entered.wait(timeout=WAIT)     # the dispatcher is in a forward
    batcher._q.put(None)
    batcher._q.put(({}, "straggler", straggler, None))
    stub.release.set()
    batcher._thread.join(timeout=WAIT)
    assert not batcher._thread.is_alive()
    assert first.result(timeout=WAIT)["example_id"] == "first"
    with pytest.raises(RuntimeError, match="closed"):
        straggler.result(timeout=WAIT)


def _until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _background(port, ids, out, **extra):
    t = threading.Thread(target=lambda: out.append(_request(port, "/score",
                                                            _body(ids, **extra))))
    t.start()
    return t


def test_overload_sheds_429_with_retry_after_and_bounds_the_queue():
    """One request in the forward, the queue (2 examples) full: the next two
    are shed at once with 429, Retry-After 1 and "retriable"; the accepted
    three are served when the forward returns."""
    stub = GatedStub()
    server = tserve(stub, port=0, block=False, max_wait_ms=1.0, max_queue_batches=2)
    port, batcher = server.server_address[1], server.modcr_batcher
    done, threads = [], []
    try:
        threads.append(_background(port, [0], done))
        assert stub.entered.wait(timeout=WAIT)
        for i in (1, 2):
            threads.append(_background(port, [i], done))
            _until(lambda i=i: batcher.queue_depth() == i, f"request {i} queued")
        shed = [_request(port, "/score", _body([i])) for i in (3, 4)]
        assert [(code, retry) for code, _, retry in shed] == [(429, "1")] * 2
        assert all(body["retriable"] for _, body, _ in shed)
        assert batcher.queue_depth() == batcher.capacity == 2
        route = _request(port, "/stats")[1]["routes"]["score"]
        assert route["shed_rejected"] == 2 and route["queue_capacity"] == 2
        stub.release.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert sorted(code for code, _, _ in done) == [200] * 3
    finally:
        stub.release.set()
        server.modcr_close()


def test_expired_deadline_is_503_and_dropped_in_the_queue():
    stub = GatedStub()
    server = tserve(stub, port=0, block=False, max_wait_ms=1.0, max_queue_batches=8)
    port, batcher = server.server_address[1], server.modcr_batcher
    done = []
    try:
        first = _background(port, [0], done)
        assert stub.entered.wait(timeout=WAIT)
        code, body, retry = _request(port, "/score", _body([1], deadline_ms=50))
        assert (code, retry) == (503, "1") and body["retriable"]
        stub.release.set()
        first.join(timeout=WAIT)
        assert done[0][0] == 200
        _until(lambda: batcher.expired == 1, "the expired request dropped in the queue")
        assert batcher.telemetry() == [1]          # it never reached a forward
        stats = _request(port, "/stats")[1]
        assert stats["errors"] == 1 and stats["routes"]["score"]["shed_expired"] == 1
    finally:
        stub.release.set()
        server.modcr_close()


@pytest.mark.parametrize("where", ["per call", "batcher default"])
def test_batcher_deadline_raises(where):
    stub = GatedStub()
    batcher = MicroBatcher(stub, max_wait_ms=1.0,
                           default_deadline_ms=50 if where == "batcher default" else None)
    try:
        with pytest.raises(DeadlineExceeded):
            batcher.score([_example(tschemas, 0)],
                          deadline_ms=50 if where == "per call" else None)
        assert stub.entered.is_set()
    finally:
        stub.release.set()
        batcher.close()


def test_oversized_request_is_admitted_on_an_idle_queue_only():
    """A request larger than the whole queue is taken when the queue is
    empty (not shed forever), and shed while anything is queued."""
    stub = GatedStub(gated=False)
    batcher = MicroBatcher(stub, max_wait_ms=1.0, max_queue_batches=2)
    try:
        examples = [_example(tschemas, i) for i in range(batcher.capacity + 3)]
        assert len(batcher.score(examples)) == len(examples)
        stub.release.clear()
        stub.entered.clear()
        busy = threading.Thread(target=batcher.score, args=([examples[0]],))
        busy.start()
        assert stub.entered.wait(timeout=WAIT)
        queued = threading.Thread(target=batcher.score, args=([examples[1]],))
        queued.start()
        _until(lambda: batcher.queue_depth() == 1, "one example queued")
        with pytest.raises(Overloaded):
            batcher.score(examples)
        assert batcher.rejected == len(examples)
        stub.release.set()
        for t in (busy, queued):
            t.join(timeout=WAIT)
    finally:
        stub.release.set()
        batcher.close()


# ---------------------------------------------------------------- the command

def _capture(monkeypatch, module):
    captured = {}

    def fake_serve(scorer, host, port, **kw):
        captured.update(scorer=scorer, addr=(host, port), **kw)

    monkeypatch.setattr(module, "serve", fake_serve)
    return captured


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A feature pickle, and a run_pmr-style model directory (config.json and
    a best checkpoint) holding the JAX serve command's random init."""
    from multimodal_context_reasoning_tpu.serving import server as jserver

    d = tmp_path_factory.mktemp("serve_cli")
    rng = np.random.default_rng(0)
    dim = TConfig.tiny().global_encoder.img_feature_dim
    with open(d / "feats.pkl", "wb") as f:
        pickle.dump({f"img-{i}": {"features": rng.normal(size=(5, dim)).astype(np.float32)}
                     for i in range(4)}, f)
    with pytest.MonkeyPatch.context() as mp:
        jcap = _capture(mp, jserver)
        jserve_cli.main(["--img_feat_file", str(d / "feats.pkl"), "--tiny"])
    cfg = TConfig.tiny()
    model = TModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jcap["scorer"].params), cfg))
    save_config(str(d / "model"), "config.json", cfg)
    CheckpointManager(str(d / "model" / "ckpt"), params_only=True).save(
        types.SimpleNamespace(model=model, step=1), {"accuracy": 1.0})
    return dict(pkl=str(d / "feats.pkl"), model=str(d / "model"))


def test_serve_cli_builds_warms_and_serves(cli_files, monkeypatch, capsys):
    """main(): features, hash tokenizers, a seeded random init, the scorer
    built and warmed before the "serving on" line, then serve()."""
    from multimodal_context_reasoning_torch.serving import server as tserver

    order = []
    warm = TScorer.warm_up
    monkeypatch.setattr(TScorer, "warm_up", lambda self: (order.append("warm"), warm(self)))
    captured = _capture(monkeypatch, tserver)
    tserve_cli.main(["--img_feat_file", cli_files["pkl"], "--tiny", "--micro_batch", "2",
                     "--port", "9", "--device", "cpu", "--max_queue_batches", "3",
                     "--deadline_ms", "250", "--max_rationale_len", "8",
                     "--gen_micro_batch", "2"])
    assert order == ["warm"] and "serving on http://127.0.0.1:9" in capsys.readouterr().out
    sc = captured["scorer"]
    assert sc.micro_batch == 2 and captured["addr"] == ("127.0.0.1", 9)
    assert captured["max_queue_batches"] == 3 and captured["default_deadline_ms"] == 250
    out = sc.score([_example(tschemas, 1)])
    assert len(out) == 1 and np.isfinite(out[0]["logits"]).all()


@pytest.mark.parametrize("params_dtype", [None, "float32", "bfloat16"])
def test_serve_cli_scores_as_the_jax_cli(cli_files, monkeypatch, params_dtype):
    """The same weights through both commands (the JAX one's random init,
    saved for the port's --eval_model_dir) give the same scores under the
    same --params_dtype."""
    from multimodal_context_reasoning_tpu.serving import server as jserver
    from multimodal_context_reasoning_torch.serving import server as tserver

    flag = ["--params_dtype", params_dtype] if params_dtype else []
    jcap = _capture(monkeypatch, jserver)
    jserve_cli.main(["--img_feat_file", cli_files["pkl"], "--tiny", "--micro_batch", "2",
                     *flag])
    tcap = _capture(monkeypatch, tserver)
    tserve_cli.main(["--img_feat_file", cli_files["pkl"], "--eval_model_dir", cli_files["model"],
                     "--micro_batch", "2", "--device", "cpu", *flag])
    ids = [0, 1, 2, 3, 5]
    want = jcap["scorer"].score([_example(jschemas, i) for i in ids])
    got = tcap["scorer"].score([_example(tschemas, i) for i in ids])
    _assert_same_results(got, want)


def test_serve_cli_quantized_scores_as_the_jax_cli(cli_files, monkeypatch):
    """serve --quantize int8: the port's scorer quantizes every int8 site
    once (the same bits as per call), and scores as the JAX command's int8
    scorer on the same weights (tests/test_torch_quant.py's tolerance: a
    code may flip at a rounding tie in the jitted JAX program)."""
    from multimodal_context_reasoning_tpu.serving import server as jserver
    from multimodal_context_reasoning_torch.models.layers import Linear
    from multimodal_context_reasoning_torch.serving import server as tserver
    from tests.test_torch_quant import assert_int8_close

    jcap = _capture(monkeypatch, jserver)
    jserve_cli.main(["--img_feat_file", cli_files["pkl"], "--tiny", "--micro_batch", "2",
                     "--quantize", "int8"])
    tcap = _capture(monkeypatch, tserver)
    tserve_cli.main(["--img_feat_file", cli_files["pkl"], "--eval_model_dir", cli_files["model"],
                     "--micro_batch", "2", "--device", "cpu", "--quantize", "int8"])
    sc = tcap["scorer"]
    assert sc.config.roberta.quantize == sc.config.global_encoder.quantize == "int8"
    linears = [m for m in sc.model.modules() if isinstance(m, Linear) and m.quantize]
    assert linears and all(m.int8_codes is not None for m in linears)
    exs = [0, 1, 2, 3, 5]
    got = sc.score([_example(tschemas, i) for i in exs])
    for m in linears:
        m.int8_codes = m.int8_scale = None           # quantize per call instead
    assert sc.score([_example(tschemas, i) for i in exs]) == got
    want = jcap["scorer"].score([_example(jschemas, i) for i in exs])
    assert_int8_close([r["logits"] for r in got], [r["logits"] for r in want])


def test_serve_cli_generate_serves_a_seeded_random_init(cli_files, monkeypatch, capsys):
    """serve --generate without --rationale_ckpt: the tiny family from a
    seeded random init, warmed before "serving on", with the hash GPT
    tokenizer of its vocabulary."""
    from multimodal_context_reasoning_torch.serving import server as tserver
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator

    order = []
    warm = RationaleGenerator.warm_up
    monkeypatch.setattr(RationaleGenerator, "warm_up",
                        lambda self: (order.append("warm"), warm(self)))
    cap = _capture(monkeypatch, tserver)
    argv = ["--img_feat_file", cli_files["pkl"], "--tiny", "--device", "cpu", "--generate",
            "--gen_micro_batch", "3", "--max_rationale_len", "5"]
    tserve_cli.main(argv)
    assert order == ["warm"] and "/generate on" in capsys.readouterr().out
    gen = cap["generator"]
    assert gen.micro_batch == 3 and gen.gpt_tokenizer.vocab_size == 128
    assert next(gen.model.parameters()).dtype == torch.bfloat16     # --compute_dtype
    assert gen.model.dec.wte.weight.dtype == torch.float32          # the decoder: fp32
    out = gen.generate([_example(tschemas, i) for i in range(4)])
    assert [len(r["probs"]) for r in out] == [4] * 4
    assert all(0 <= t < 128 and len(r["rationale_ids"]) <= 5 for r in out
               for t in r["rationale_ids"])
    again = _capture(monkeypatch, tserver)
    tserve_cli.main(argv)
    assert again["generator"].generate([_example(tschemas, 0)]) == out[:1]


@pytest.mark.parametrize("flag", ["--gpt_tokenizer_dir", "--bert_tokenizer_dir",
                                  "--roberta_tokenizer_dir"])
def test_serve_cli_tokenizer_dir_without_transformers_exits_naming_it(
        cli_files, monkeypatch, tmp_path, flag):
    """Without transformers a tokenizer directory is a SystemExit that names
    the package, not a fallback to the hash tokenizer."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    argv = ["--img_feat_file", cli_files["pkl"], "--device", "cpu", "--tiny",
            "--compute_dtype", "float32", "--generate", "--gen_micro_batch", "1",
            flag, str(tmp_path)]
    with pytest.raises(SystemExit, match=rf"{flag} needs the 'transformers' package"):
        tserve_cli.main(argv)


def test_serve_cli_runs_on_the_card_unless_asked_for_the_cpu(cli_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve_cli.main(["--img_feat_file", cli_files["pkl"], "--tiny"])
