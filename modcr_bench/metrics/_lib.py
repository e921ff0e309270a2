"""Shared arithmetic of the metric readers.  A reader is ``read(run)``
returning the metric's value, or None where the run has nothing to read
(the harness then leaves the metric out of the line)."""

from __future__ import annotations

from typing import Optional

from modcr_bench import counts


def per_second(run, key: str) -> Optional[float]:
    n = run.stats.get(key)
    return None if n is None else n / run.stats["seconds"]


def mfu(run) -> Optional[float]:
    """Model FLOPs of a window step over the seconds a step takes outside
    the traced spans (``Summary.pace_s``), at the bf16 peak."""
    t = run.trace
    if t is None or not t.pace_s:
        return None
    flops = counts.MODEL_FLOPS[run.conf["kind"]](run.model, run.cell["traffic"]["questions_per_batch"])
    return 100.0 * flops / t.pace_s / counts.PEAK_FLOPS


def idle_pct(run) -> Optional[float]:
    """1 - (union of kernel intervals / the profiled span), both from the
    trace of span A."""
    t = run.trace
    return None if t is None or t.span_s <= 0 else 100.0 * (1.0 - t.busy_s / t.span_s)


def roofline(run, op: str) -> Optional[float]:
    return None if run.trace is None else run.trace.roofline_pct(op)


def kernel_ms_per_step(run, *needles: str) -> Optional[float]:
    t = run.trace
    if t is None or t.steps <= 0:
        return None
    s = t.kernel_seconds(*needles)
    return 1e3 * s / t.steps if s > 0 else None


GEMM = ("nvjet", "gemm", "gemv", "cutlass", "xmma", "splitk")


def loader_wait_ms(run) -> Optional[float]:
    w = run.stats.get("loader_wait_s")
    return None if w is None else 1e3 * w / run.stats["steps"]
