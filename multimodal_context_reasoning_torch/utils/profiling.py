"""Profiling hooks (port of the JAX package's ``utils/profiling.py``), and
the program's own spans and counters.

:func:`trace` is a ``torch.profiler`` capture, with CUDA activity when the
card is there, that writes a Chrome trace into ``log_dir``.

:func:`span` times a stage of the program on the host, and :func:`count`
counts events, both into one table per process:

- spans are off by default (:func:`enable_spans`): ``span`` then checks one
  flag and returns a shared no-op context.  They are also off while the
  program is traced by ``torch.compile`` or ``torch.export``, so a traced
  graph is the same with spans on;
- on, each span keeps a :class:`SpanRecord`: its start and end on
  ``time.time_ns()`` (the clock of a Kineto trace, so a span lies over the
  kernels it launched), its parent on its thread's stack of open spans, the
  thread, the batch's sequence number ``seq`` where it has one, and whether
  a ``torch.profiler`` capture was running (``profiled``; the span then
  also opens a ``record_function`` of its name, so a Chrome trace shows
  it).  The records of a name go into a ring of :data:`RING`, so a long run
  holds constant memory; its count, total and self time (less the time its
  children cover) run on;
- counters are always on (:func:`count`, :func:`counter`, :func:`set_counter`)
  and run on across :func:`reset_spans`; :func:`recording_counts` also notes
  a thread's counts on a tape.

:func:`by_span` puts a capture's device idle time and kernel time down to
the spans that were open on the host.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd import DeviceType

RING = 4096            # records kept per span name
OUTSIDE = "outside"    # by_span's name for time under no span

_ON = False
_NO_SPAN = contextlib.nullcontext()
_LOCK = threading.Lock()
_LOCAL = threading.local()
_RECORDS: Dict[str, deque] = {}
_TOTALS: Dict[str, List[int]] = {}      # name -> [count, total ns, self ns]
_COUNTS: Dict[str, int] = {}


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    thread: int              # threading.get_ident() of the thread it ran on
    seq: Optional[int]
    profiled: bool


class _Span:
    __slots__ = ("name", "seq", "parent", "start", "child_ns", "profiled", "rf")

    def __init__(self, name: str, seq: Optional[int]):
        self.name, self.seq, self.child_ns, self.rf = name, seq, 0, None

    def __enter__(self) -> "_Span":
        stack = _LOCAL.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self)
        # the profiler's process-wide flag: ``torch.autograd._profiler_enabled()``
        # is true only on the thread that started the capture
        self.profiled = _autograd_profiler._is_profiler_enabled
        self.start = time.time_ns()
        if self.profiled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        _LOCAL.stack.pop()
        ns = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += ns
        rec = SpanRecord(self.name, self.start, end, parent.name if parent else None,
                         threading.get_ident(), self.seq, self.profiled)
        with _LOCK:
            ring = _RECORDS.get(self.name)
            if ring is None:
                ring = _RECORDS[self.name] = deque(maxlen=RING)
                _TOTALS[self.name] = [0, 0, 0]
            ring.append(rec)
            t = _TOTALS[self.name]
            t[0] += 1
            t[1] += ns
            t[2] += ns - self.child_ns
        return False


def span(name: str, seq: Optional[int] = None):
    """A context that records the host time of what runs inside as a span
    ``name`` (``seq``: the batch's sequence number), when spans are on."""
    if not _ON or torch.compiler.is_compiling():
        return _NO_SPAN
    return _Span(name, seq)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and note it on this thread's tape,
    :func:`recording_counts`)."""
    tape = getattr(_LOCAL, "tape", None)
    if tape is not None:
        tape.append((name, n))
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


@contextlib.contextmanager
def recording_counts(tape: Optional[list]) -> Iterator[None]:
    """Inside, on this thread, every :func:`count` also appends ``(name, n)``
    to ``tape`` (``None``: to no tape), so a captured graph can count again
    on each replay what its capture counted."""
    prev = getattr(_LOCAL, "tape", None)
    _LOCAL.tape = tape
    try:
        yield
    finally:
        _LOCAL.tape = prev


def counter(name: str) -> int:
    return _COUNTS.get(name, 0)


def set_counter(name: str, n: int) -> None:
    """Set the counter ``name`` to ``n``."""
    with _LOCK:
        _COUNTS[name] = n


def enable_spans(on: bool) -> bool:
    """Switch spans on or off; returns whether they were on."""
    global _ON
    was, _ON = _ON, bool(on)
    return was


def span_records(name: str) -> List[SpanRecord]:
    """The kept records of span ``name``, oldest first."""
    with _LOCK:
        return list(_RECORDS.get(name, ()))


def span_table() -> Dict:
    """Per span name: its count, total and self ms, and the median ms of its
    kept records; and every counter."""
    with _LOCK:
        spans = {n: {"count": t[0], "total_ms": t[1] / 1e6, "self_ms": t[2] / 1e6,
                     "median_ms": statistics.median(r.end_ns - r.start_ns
                                                    for r in _RECORDS[n]) / 1e6}
                 for n, t in sorted(_TOTALS.items())}
        return {"spans": spans, "counters": dict(sorted(_COUNTS.items()))}


def reset_spans() -> None:
    """Forget every span (the counters run on)."""
    with _LOCK:
        _RECORDS.clear()
        _TOTALS.clear()


def write_spans(path: str, prof: Optional[torch.profiler.profile] = None) -> Dict:
    """Write :func:`span_table` as JSON to ``path``, with :func:`by_span` of
    ``prof`` beside it under ``by_span`` when given; returns what it wrote."""
    out = span_table()
    if prof is not None:
        out["by_span"] = by_span(prof)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def _innermost(records: Sequence[SpanRecord], points: Sequence[int]) -> List[str]:
    """The name of the innermost of ``records`` (one thread's, so nested)
    open at each of ``points``, or :data:`OUTSIDE`."""
    spans = sorted(records, key=lambda r: (r.start_ns, -r.end_ns))
    out = [OUTSIDE] * len(points)
    stack: List[SpanRecord] = []
    i = 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        p = points[k]
        while i < len(spans) and spans[i].start_ns <= p:
            while stack and stack[-1].end_ns <= spans[i].start_ns:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end_ns <= p:
            stack.pop()
        if stack:
            out[k] = stack[-1].name
    return out


def device_time_by_span(kernels: Sequence[Tuple[int, int, Optional[int]]], start_ns: int,
                        end_ns: int, records: Sequence[SpanRecord]) -> Dict[str, Dict[str, float]]:
    """Per span name, ``idle_s`` and ``kernel_s`` over the window
    ``[start_ns, end_ns)`` of one thread's ``records``.  ``kernels`` are
    device intervals ``(start, end, launch)``, with the host time ``launch``
    of the call that launched each (None where unknown).  Every gap between
    the merged kernel intervals, the window's edges included, goes to the
    innermost span open at the gap's start; each kernel's time to the one
    open at its launch.  So the idle seconds sum to the window less the
    union of the kernels."""
    ks = sorted((max(a, start_ns), min(b, end_ns), c) for a, b, c in kernels
                if b > start_ns and a < end_ns)
    gaps: List[Tuple[int, int]] = []
    edge = start_ns
    for a, b, _ in ks:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if end_ns > edge:
        gaps.append((edge, end_ns))
    out: Dict[str, Dict[str, float]] = {}

    def add(name: str, key: str, ns: int) -> None:
        d = out.setdefault(name, {"idle_s": 0.0, "kernel_s": 0.0})
        d[key] += ns / 1e9

    for (a, b), name in zip(gaps, _innermost(records, [a for a, _ in gaps])):
        add(name, "idle_s", b - a)
    launched = [(a, b, c) for a, b, c in ks if c is not None]
    for (a, b, _), name in zip(launched, _innermost(records, [c for _, _, c in launched])):
        add(name, "kernel_s", b - a)
    for a, b, c in ks:
        if c is None:
            add(OUTSIDE, "kernel_s", b - a)
    return out


def by_span(prof: torch.profiler.profile,
            thread: Optional[int] = None) -> Dict[str, Dict[str, float]]:
    """:func:`device_time_by_span` of a finished capture (CUDA activity
    alone, or with the host's), over the spans of ``thread`` (default: the
    main thread, which launches the kernels): from the capture's start to
    the end of its last event, with each kernel, copy or set launched at
    the start of the runtime call of its correlation id; empty for a
    capture with no device activity.  Kineto's times are on
    ``time.time_ns()``'s clock, as the spans' are."""
    thread = threading.main_thread().ident if thread is None else thread
    res = prof.profiler.kineto_results
    events = res.events()
    start = end = res.trace_start_ns()
    # a range's twin on the card's timeline (a host capture's annotations)
    # is no kernel
    annotations = {e.name() for e in events if e.is_user_annotation()}
    device, runtime = [], {}
    for e in events:
        end = max(end, e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() not in annotations:
                device.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):     # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...
            runtime[e.correlation_id()] = e.start_ns()
    with _LOCK:
        records = [r for ring in _RECORDS.values() for r in ring
                   if r.thread == thread and r.end_ns > start and r.start_ns < end]
    if not device:      # a host-only capture: no device time to put down
        return {}
    kernels = [(a, b, runtime.get(c)) for a, b, c in device]
    return device_time_by_span(kernels, start, end, records)


def activities(device: Optional[torch.device] = None) -> list:
    """What a capture records: the host's ops, and the card's kernels when
    ``device`` (default: any card present) is CUDA."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available() if device is None else device.type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def synchronize(device: Optional[torch.device] = None) -> None:
    """Wait for the card (``device``, default: any card present) to finish
    its queued work; nothing to wait for on the CPU."""
    cuda = torch.cuda.is_available() if device is None else device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)


def start_trace(device: Optional[torch.device] = None) -> torch.profiler.profile:
    """A started ``torch.profiler.profile``; :func:`stop_trace` ends it."""
    prof = torch.profiler.profile(activities=activities(device))
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str,
               device: Optional[torch.device] = None) -> str:
    """Stop ``prof`` (after the card has finished the captured work) and
    write its Chrome trace into ``log_dir``; returns the file's path."""
    synchronize(device)
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str],
          device: Optional[torch.device] = None) -> Iterator[Optional[torch.profiler.profile]]:
    """Capture what runs inside into a Chrome trace under ``log_dir``
    (viewable in ``chrome://tracing`` or Perfetto); yields the profile, or
    does nothing and yields None when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    prof = start_trace(device)
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir, device)
