"""The traced run: ``torch.profiler`` over two bounded spans of the
window's steps, kept in memory, reduced to what the per-layer readers need.

- Span A, ``steps`` steps from step ``start``, records the card alone
  (CUDA activity, so that the host's launches are slowed as little as
  tracing allows): kernel times, the device's busy share of the span and
  the idle gaps, all from the trace.  The span runs from the profiler's
  start to the synchronise that closes it; a device event that starts
  outside it is counted (``Summary.strays``) and left out.  The untraced
  steps' pace of the same run (``Summary.pace_s``) is printed beside the
  span's, so the profiler's own cost shows.
- Span B, the next ``steps`` steps, records host ops with their argument
  shapes as well: each ``modcr_torch`` op call's shapes and the device
  time of the kernels it launched, for the rooflines.

Each span opens and closes on a synchronised device.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import counts


@dataclasses.dataclass
class Summary:
    span_s: float                                  # span A, profiler start to closing sync
    pace_s: Optional[float]                        # a window step outside the spans
    busy_s: float                                  # union of kernel intervals in span A
    steps: int                                     # window steps inside span A
    kernel_s: Dict[str, float]                     # device seconds by kernel name, span A
    strays: int                                    # span A's device events outside it
    op_calls: Dict[str, List[Tuple[float, float]]]  # span B: op -> [(bound s, device s)]
    gaps: List[Tuple[str, float]]                  # span A idle seconds by host activity

    def kernel_seconds(self, *needles: str) -> float:
        """Device seconds of the kernels whose lower-cased name holds any of
        ``needles``."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k.lower() for n in needles))

    def roofline_pct(self, op: str) -> Optional[float]:
        calls = self.op_calls.get(op)
        if not calls:
            return None
        device = sum(d for _, d in calls)
        return 100.0 * sum(b for b, _ in calls) / device if device > 0 else None


class Tracer:
    """Span A over window steps [start, start + steps), span B over the
    next ``steps`` steps, when ``enabled``; otherwise nothing.
    ``step(i)`` is called before window step ``i``."""

    def __init__(self, enabled: bool, start: int = 1, steps: int = 4):
        self.enabled, self.start, self.steps = enabled, start, steps
        self.prof: List = []          # [(profile, host seconds, steps)]
        self._open = None
        self._t0 = None
        self.stamps: Dict[int, float] = {}
        if enabled:
            # the profiler's first start initialises CUPTI (seconds): do it
            # before the window
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def step(self, i: int) -> None:
        if not self.enabled:
            return
        if i == self.start:
            self._begin(i, [ProfilerActivity.CUDA], False)
        elif i == self.start + self.steps:
            self._end(i)
            self._begin(i, [ProfilerActivity.CPU, ProfilerActivity.CUDA], True)
        elif i == self.start + 2 * self.steps:
            self._end(i)
        # after the profiler's own work: a step's time is stamp to stamp
        self.stamps[i] = time.perf_counter()

    def finish(self, i: int) -> None:
        """The window ended after ``i`` steps."""
        if self.enabled:
            self.stamps[i] = time.perf_counter()
        if self._open is not None:
            self._end(i)

    def _begin(self, i: int, activities, shapes: bool) -> None:
        # the device is idle when a span opens, so its every kernel is
        # one of the span's steps
        torch.cuda.synchronize()
        self._open = profile(activities=activities, record_shapes=shapes)
        self._t0, self._first = time.perf_counter(), i
        self._open.__enter__()

    def _end(self, i: int) -> None:
        torch.cuda.synchronize()
        seconds = time.perf_counter() - self._t0
        self._open.__exit__(None, None, None)
        self.prof.append((self._open, seconds, i - self._first))
        self._open = None

    def summary(self) -> Optional[Summary]:
        if not self.prof:
            return None
        (a, host_s, steps), rest = self.prof[0], self.prof[1:]
        span_s, kernel_s, busy, strays, gaps = device_time(a, host_s)
        op_calls = op_rooflines(rest[0][0]) if rest else {}
        # steps whose time holds no profiler work: before the step that
        # opens span A, and from the one that closes span B
        end = self.start + 2 * self.steps
        free = [self.stamps[i + 1] - self.stamps[i] for i in self.stamps
                if (i + 1 < self.start or i >= end) and i + 1 in self.stamps]
        return Summary(span_s=span_s, pace_s=sum(free) / len(free) if free else None,
                       busy_s=busy, steps=steps, kernel_s=kernel_s, strays=strays,
                       op_calls=op_calls, gaps=gaps)


def _is_device(e) -> bool:
    """A kernel, copy or set on the card (not an annotation's device range)."""
    return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False) \
        and not e.name.startswith("bench.")


def _is_host(e) -> bool:
    return e.device_type == DeviceType.CPU


def _op_dtypes(prof, calls) -> List[List[str]]:
    """The argument dtypes of each op call, from the event where this
    torch records them, else from the profiler's raw events of the same
    name, in the same order."""
    if all(getattr(e, "input_dtypes", None) for e in calls):
        return [list(e.input_dtypes) for e in calls]
    raw: Dict[str, list] = defaultdict(list)
    for k in prof.profiler.kineto_results.events():
        if k.name().startswith("modcr_torch::") and k.device_type() == DeviceType.CPU:
            raw[k.name()].append((k.start_ns(), list(k.dtypes())))
    for v in raw.values():
        v.sort(key=lambda x: x[0])
    seen: Dict[str, int] = defaultdict(int)
    out = []
    for e in calls:
        i = seen[e.name]
        seen[e.name] += 1
        out.append(raw[e.name][i][1] if i < len(raw[e.name]) else [])
    return out


def device_time(prof, host_s: float):
    """(span seconds, seconds by kernel name, busy seconds, device events
    outside the span, idle gaps by host activity) of a span.  Event times
    count from the profiler's start; the span runs from there to the end
    of its last event, the closing synchronise.  An event that starts
    before the profiler's start or after ``host_s`` (the host clock's
    reading from just before the start to that synchronise) is not the
    span's own."""
    events = prof.events()
    inside = [e for e in events if 0 <= e.time_range.start <= host_s * 1e6]
    span_s = max((e.time_range.end for e in inside), default=host_s * 1e6) / 1e6
    device = sum(1 for e in events if _is_device(e))
    kernels = sorted((e for e in inside if _is_device(e)), key=lambda e: e.time_range.start)
    kernel_s: Dict[str, float] = defaultdict(float)
    merged: List[List[float]] = []
    for e in kernels:
        a, b = e.time_range.start, e.time_range.end
        kernel_s[e.name] += (b - a) / 1e6
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    # idle gaps between kernels, named by the innermost host event (a
    # runtime call, an annotation) open at the gap's start
    host = sorted((e for e in events if _is_host(e)), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps = sorted(((merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:500]
    by_name: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        name = "host"
        j = bisect.bisect_right(starts, a) - 1
        while j >= 0 and a - host[j].time_range.start < 1e6:
            if host[j].time_range.end >= a:
                name = host[j].name
                break
            j -= 1
        by_name[name] += (b - a) / 1e6
    return (span_s, dict(kernel_s), busy, device - len(kernels),
            sorted(by_name.items(), key=lambda kv: -kv[1]))


def op_rooflines(prof) -> Dict[str, List[Tuple[float, float]]]:
    """Each ``modcr_torch`` op call's (bound seconds, device seconds of the
    kernels it launched)."""
    events = prof.events()
    op_calls: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    calls = sorted((e for e in events if _is_host(e) and e.name.startswith("modcr_torch::")),
                   key=lambda e: e.time_range.start)
    for e, types in zip(calls, _op_dtypes(prof, calls)):
        concrete = getattr(e, "concrete_inputs", None) or []
        # flash_bwd's want_dbias: False where the trace does not record it
        # (every path of these cells passes False)
        want_dbias = bool(concrete[5]) if len(concrete) > 5 and concrete[5] is not None else False
        work = counts.op_work(e.name, e.input_shapes, types, want_dbias)
        if work is not None:
            op_calls[e.name.split("::")[1]].append(
                (counts.bound_seconds(*work), e.device_time_total / 1e6))
    return dict(op_calls)
