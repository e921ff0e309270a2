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
from multimodal_context_reasoning_tpu.core.config import ModCRConfig as JConfig
from multimodal_context_reasoning_tpu.data import schemas as jschemas
from multimodal_context_reasoning_tpu.data import tokenization as jtok
from multimodal_context_reasoning_tpu.models.modcr import ModCRModel as JModel
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


def test_serve_refuses_a_generator(pair):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        tserve(pair["t"], port=0, block=False, generator=object())


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


REFUSED = [
    (["--quantize", "int8"], "--quantize int8", 6),
    (["--generate"], "--generate", 7),
    (["--rationale_ckpt", "r.pth"], "--rationale_ckpt", 7),
    (["--gpt_tokenizer_dir", "gpt"], "--gpt_tokenizer_dir", 7),
    (["--gen_artifact", "a"], "--gen_artifact", 7),
    (["--save_gen_artifact", "a"], "--save_gen_artifact", 7),
    (["--artifact", "a"], "--artifact", 9),
    (["--save_artifact", "a"], "--save_artifact", 9),
    (["--device_features"], "--device_features", 9),
    (["--bert_tokenizer_dir", "b"], "--bert_tokenizer_dir", 11),
    (["--roberta_tokenizer_dir", "r"], "--roberta_tokenizer_dir", 11),
]


@pytest.mark.parametrize("flags,name,item", REFUSED, ids=[r[1] for r in REFUSED])
def test_serve_cli_refuses_unported_flags_before_reading_data(tmp_path, flags, name, item):
    argv = ["--img_feat_file", str(tmp_path / "absent.pkl"), "--device", "cpu", *flags]
    with pytest.raises(SystemExit, match=rf"{name}.*ROADMAP Queue 1 item {item}\)"):
        tserve_cli.main(argv)


def test_serve_cli_runs_on_the_card_unless_asked_for_the_cpu(cli_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve_cli.main(["--img_feat_file", cli_files["pkl"], "--tiny"])
