"""Minimal HTTP scoring server, standard library only (port of the JAX
package's ``serving/server.py``).

POST /score    body ``{"examples": [{"example_id", "img_id", "premise",
               "answer_choices": [4 strings]}, ...], "deadline_ms"?}`` ->
               ``{"results": [{"example_id", "prediction", "logits",
               "probs"}, ...]}``
POST /generate the same body, served by a :class:`RationaleGenerator`
               (``serve(generator=...)``) -> results with "prediction",
               "probs" and "rationale_ids" (and "rationale_text" where the
               GPT tokenizer can decode); without a generator 404
               ``{"error": "no generator configured"}``.
GET  /healthz  liveness.
GET  /stats    request and example counts, errors, and per route recent
               request-latency percentiles, the batcher's forward sizes
               (mean batch: how well requests coalesce), live queue depth
               and shed counters.

Back-pressure: the batcher's queue is bounded (``max_queue_batches``); when
it is full a new request gets 429 with ``Retry-After: 1``, and a request
whose ``deadline_ms`` (its own field or the server default) passes gets 503.
Any other failure is a 500 naming the exception's type; a request without
examples or with a missing field is a 400.

One difference from the JAX server: the listening socket's backlog is 128
connections, not the standard library's 5, whose overflow resets a burst of
concurrent clients.

Requests are scored through :class:`ModCRScorer` via a cross-request
:class:`MicroBatcher` (serving/batcher.py): concurrent clients' examples
that arrive within ``max_wait_ms`` are grouped into one forward up to the
scorer's micro-batch; /generate has a batcher of its own over the
generator's micro-batch of questions.  ``batching=False`` serializes whole
requests on one lock per route instead.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from multimodal_context_reasoning_torch.data.schemas import RawExample
from multimodal_context_reasoning_torch.serving.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Overloaded,
)


class _Server(ThreadingHTTPServer):
    # the standard library listens with a backlog of 5, and a burst of more
    # concurrent connects than that is reset (the JAX server's behaviour);
    # the port listens deeper
    request_queue_size = 128


class ServerStats:
    """Thread-safe request telemetry, bounded for a long-lived server."""

    def __init__(self, batcher: Optional[MicroBatcher] = None,
                 gen_batcher: Optional[MicroBatcher] = None):
        self._lock = threading.Lock()
        self._batchers = (("score", batcher), ("generate", gen_batcher))
        self.requests = 0
        self.examples = 0
        self.errors = 0
        # per-route latency windows: a /generate call (classify + decode) is
        # far slower than a /score call, so one window would mix them
        self._routes: dict = {}

    def _route(self, route: str) -> dict:
        r = self._routes.get(route)
        if r is None:
            r = self._routes[route] = {
                "requests": 0, "examples": 0, "lat": collections.deque(maxlen=4096)}
        return r

    def record(self, route: str, n_examples: int, seconds: float) -> None:
        with self._lock:
            self.requests += 1
            self.examples += n_examples
            r = self._route(route)
            r["requests"] += 1
            r["examples"] += n_examples
            r["lat"].append(seconds)

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    @staticmethod
    def _lat_stats(lat) -> dict:
        lat = sorted(lat)
        return {
            "p50": round(1e3 * lat[len(lat) // 2], 1),
            "p90": round(1e3 * lat[int(len(lat) * 0.9)], 1),
            "max": round(1e3 * lat[-1], 1),
            "window": len(lat),
        }

    def snapshot(self) -> dict:
        with self._lock:
            out = {"requests": self.requests, "examples": self.examples,
                   "errors": self.errors}
            routes = {
                name: {"requests": r["requests"], "examples": r["examples"],
                       "latency_ms": self._lat_stats(r["lat"])}
                for name, r in self._routes.items() if r["lat"]
            }
        if routes:
            out["routes"] = routes
        for name, b in self._batchers:
            if b is None:
                continue
            route = out.setdefault("routes", {}).setdefault(name, {})
            route.update(queue_depth=b.queue_depth(), queue_capacity=b.capacity,
                         shed_rejected=b.rejected, shed_expired=b.expired)
            sizes = b.telemetry()
            if sizes:
                route.update(device_dispatches=len(sizes),
                             mean_device_batch=round(sum(sizes) / len(sizes), 2))
        return out


def _make_handler(score_fn, generate_fn=None, stats: Optional[ServerStats] = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict, headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, payload: dict, headers: Optional[dict] = None) -> None:
            if stats is not None:
                stats.record_error()
            self._reply(code, payload, headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats" and stats is not None:
                self._reply(200, stats.snapshot())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            routes = {"/score": score_fn, "/generate": generate_fn}
            if self.path not in routes:
                self._reply(404, {"error": "not found"})
                return
            handler = routes[self.path]
            if handler is None:
                self._reply(404, {"error": "no generator configured"})
                return
            route = self.path[1:]
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                raw = payload.get("examples", [])
                if not raw:
                    self._error(400, {"error": "no examples"})
                    return
                examples = [
                    RawExample(
                        example_id=str(d.get("example_id", i)),
                        img_id=str(d["img_id"]),
                        premise=d["premise"],
                        answer_choices=list(d["answer_choices"]),
                        answer_label=None,
                    )
                    for i, d in enumerate(raw)
                ]
                t0 = time.perf_counter()
                results = handler(examples, deadline_ms=payload.get("deadline_ms"))
                if stats is not None:
                    stats.record(route, len(examples), time.perf_counter() - t0)
                self._reply(200, {"results": results})
            except Overloaded as e:   # the queue is at capacity: shed, retriably
                self._error(429, {"error": str(e), "retriable": True},
                            headers={"Retry-After": "1"})
            except DeadlineExceeded as e:
                self._error(503, {"error": str(e), "retriable": True},
                            headers={"Retry-After": "1"})
            except KeyError as e:
                self._error(400, {"error": f"missing field {e}"})
            except Exception as e:  # surface it, keep the server up
                self._error(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def _route_fn(endpoint, run, batching: bool, **batcher_kw):
    """(request function, batcher or None) of one endpoint: its own
    MicroBatcher, or whole requests through ``run`` serialized on one lock
    (the back-pressure knobs are the batcher's, so that path's only limit is
    a thread per connection)."""
    if batching:
        batcher = MicroBatcher(endpoint, **batcher_kw)
        return batcher.score, batcher
    lock = threading.Lock()

    def fn(examples, deadline_ms=None):
        with lock:
            return run(examples)

    return fn, None


def serve(
    scorer,
    host: str = "127.0.0.1",
    port: int = 8477,
    *,
    block: bool = True,
    batching: bool = True,
    max_wait_ms: float = 10.0,
    max_queue_batches: int = 8,
    default_deadline_ms: Optional[float] = None,
    generator=None,
) -> Optional[ThreadingHTTPServer]:
    """Serve ``scorer`` over HTTP, and ``generator`` (a
    :class:`RationaleGenerator`) at /generate when given.  ``block=False``
    returns the running server with ``modcr_batcher`` and
    ``modcr_gen_batcher`` (None without batching or a generator),
    ``modcr_stats`` and ``modcr_close()``, which stops it and closes the
    batchers."""
    kw = dict(max_wait_ms=max_wait_ms, max_queue_batches=max_queue_batches,
              default_deadline_ms=default_deadline_ms)
    score_fn, batcher = _route_fn(scorer, lambda ex: scorer.score(ex), batching, **kw)
    generate_fn = gen_batcher = None
    if generator is not None:
        # the generator has the scorer's featurize / score_featurized
        # protocol, so a MicroBatcher coalesces /generate requests as well
        generate_fn, gen_batcher = _route_fn(generator, lambda ex: generator.generate(ex),
                                               batching, **kw)

    stats = ServerStats(batcher, gen_batcher)
    server = _Server((host, port), _make_handler(score_fn, generate_fn, stats))
    server.modcr_batcher = batcher
    server.modcr_gen_batcher = gen_batcher
    server.modcr_stats = stats

    def _teardown():
        """Close the socket and the batchers' dispatcher threads."""
        server.server_close()
        for b in (batcher, gen_batcher):
            if b is not None:
                b.close()

    def modcr_close():
        server.shutdown()
        _teardown()

    server.modcr_close = modcr_close
    if block:
        try:
            server.serve_forever()
        finally:
            _teardown()
        return None
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
