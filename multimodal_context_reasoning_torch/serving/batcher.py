"""Cross-request micro-batching for the serving path (port of the JAX
package's ``serving/batcher.py``).

- Request threads featurize their own examples (numpy host work, in
  parallel across requests) and enqueue ``(features, example id, Future,
  deadline)``;
- ONE dispatcher thread drains the queue, grouping up to
  ``scorer.micro_batch`` examples that arrive within ``max_wait_ms`` of the
  first, runs them as a single forward
  (:meth:`ModCRScorer.score_featurized`), and scatters the results back
  through the futures.

The scorer is duck-typed: anything with ``featurize(example)``,
``score_featurized(feats, example_ids)`` and ``micro_batch`` works.  The
dispatcher thread runs the forwards, and so the CUDA kernels: the scorer
holds an explicit device index and the kernel wrappers enter
``torch.cuda.device(q.device)`` for each launch, and ``inference_mode`` is
entered inside ``score_featurized``, so nothing depends on this thread's
current device or grad mode.

Under load the queue fills while the card runs the current micro-batch, so
throughput approaches ``micro_batch × single-stream rate`` while a lone
request pays at most ``max_wait_ms`` extra latency.

Back-pressure: the queue is bounded at ``max_queue_batches × micro_batch``
pending examples.  When clients arrive faster than the card drains, new work
is shed at once with :class:`Overloaded` (the server's 429) instead of
growing the queue, and the latency of accepted requests, without bound.  A
request may carry a deadline: work still queued when it passes is dropped by
the dispatcher (:class:`DeadlineExceeded`, the server's 503) rather than
spending the card on an answer nobody waits for.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Deque, Dict, List, Optional, Sequence

from multimodal_context_reasoning_torch.data.schemas import RawExample


class Overloaded(RuntimeError):
    """Queue full: retriable; shed fast instead of queueing forever."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before (or while) it was served."""


class MicroBatcher:
    def __init__(
        self,
        scorer,
        *,
        max_wait_ms: float = 10.0,
        max_queue_batches: int = 8,
        default_deadline_ms: Optional[float] = None,
    ):
        self.scorer = scorer
        self.max_wait = max_wait_ms / 1000.0
        # beyond this many queued examples new work sheds with Overloaded;
        # sized in forwards, so a new arrival waits at most ~N of them
        self.capacity = max(1, max_queue_batches) * max(
            1, getattr(scorer, "micro_batch", 1))
        self.default_deadline = (
            None if default_deadline_ms is None else default_deadline_ms / 1000.0)
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # pairs the _closed check with the enqueue: a put under this lock
        # lands before close()'s sentinel, so every accepted future is
        # either dispatched or failed by the drain
        self._close_lock = threading.Lock()
        # one batch size per forward, bounded; read through telemetry(),
        # since iterating a deque another thread appends to raises
        self._stats_lock = threading.Lock()
        self.dispatch_sizes: Deque[int] = collections.deque(maxlen=4096)
        # examples rejected at the door (Overloaded) and dropped in the
        # queue past their deadline (under _stats_lock)
        self.rejected = 0
        self.expired = 0
        self._thread = threading.Thread(
            target=self._loop, name="modcr-microbatcher", daemon=True)
        self._thread.start()

    # -- client side ------------------------------------------------------
    def score(self, examples: Sequence[RawExample], *,
              deadline_ms: Optional[float] = None) -> List[Dict]:
        """Thread-safe: featurizes on the calling thread, then waits on the
        dispatcher's futures.

        Raises :class:`Overloaded` (nothing enqueued, the whole request
        shed) when the queue is at capacity, and :class:`DeadlineExceeded`
        when a deadline (per call or the batcher's default) passes before
        the results arrive.  The deadline clock starts before
        featurization: it bounds the request, not just the queue wait.
        """
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        wait = self.default_deadline if deadline_ms is None else deadline_ms / 1000.0
        deadline = None if wait is None else time.monotonic() + wait
        # shed before featurizing: under overload the host is better spent
        # on requests that will run.  qsize() is approximate across
        # threads; the bound is O(capacity), not exact.  A request larger
        # than the whole capacity is admitted once the queue has drained
        # (overshooting once by its size), so it cannot 429 forever on an
        # idle server.
        if self._q.qsize() + len(examples) > max(self.capacity, len(examples)):
            with self._stats_lock:
                self.rejected += len(examples)
            raise Overloaded(f"{self._q.qsize()} examples queued (capacity "
                             f"{self.capacity}); retry later")
        futures = []
        for ex in examples:
            feat = self.scorer.featurize(ex)  # host work, outside any lock
            f: Future = Future()
            with self._close_lock:
                if self._closed:
                    raise RuntimeError("MicroBatcher is closed")
                self._q.put((feat, ex.example_id, f, deadline))
            futures.append(f)
        out = []
        for f in futures:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                out.append(f.result(timeout=remaining))
            except FutureTimeout:
                raise DeadlineExceeded(
                    f"deadline ({wait * 1e3:.0f} ms) passed while waiting for the device")
        return out

    def queue_depth(self) -> int:
        """Approximate pending-example count (for /stats and tests)."""
        return self._q.qsize()

    def telemetry(self) -> List[int]:
        """Snapshot of recent forward batch sizes (thread-safe)."""
        with self._stats_lock:
            return list(self.dispatch_sizes)

    def close(self) -> None:
        with self._close_lock:
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout=5)

    # -- dispatcher side --------------------------------------------------
    def _loop(self) -> None:
        try:
            self._run()
        finally:
            # anything left behind the sentinel (or after _run died) is
            # failed instead of leaving its caller blocked
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[2].set_exception(RuntimeError("MicroBatcher closed"))

    def _expired(self, item) -> bool:
        """Fail (and count) a queued item whose deadline already passed."""
        dl = item[3]
        if dl is None or time.monotonic() <= dl:
            return False
        item[2].set_exception(DeadlineExceeded("deadline passed while queued"))
        with self._stats_lock:
            self.expired += 1
        return True

    def _run(self) -> None:
        mb = self.scorer.micro_batch
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._expired(item):
                continue
            items = [item]
            deadline = time.perf_counter() + self.max_wait
            while len(items) < mb:
                remaining = deadline - time.perf_counter()
                try:
                    # past the wait, still take anything already queued
                    nxt = (self._q.get_nowait() if remaining <= 0
                           else self._q.get(timeout=remaining))
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(items)
                    return
                if not self._expired(nxt):
                    items.append(nxt)
            self._dispatch(items)

    def _dispatch(self, items) -> None:
        with self._stats_lock:
            self.dispatch_sizes.append(len(items))
        try:
            results = self.scorer.score_featurized(
                [it[0] for it in items], [it[1] for it in items])
            for (_, _, fut, _), res in zip(items, results):
                fut.set_result(res)
        except Exception as e:  # surfaced to the callers
            for _, _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(e)
