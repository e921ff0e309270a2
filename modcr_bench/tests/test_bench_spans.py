"""The readers of the program's spans (``metrics/_spans.py`` and the three
``*_ms.score`` readers that use it) on a tiny CPU run of ``pmr_eval_b32``:
they read the window's last ``steps`` records, leave out those taken under
the profiler, and read nothing where the program has no span table."""

from __future__ import annotations

import copy
import importlib.util
import statistics
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_context_reasoning_torch.utils import profiling

from modcr_bench import harness
from modcr_bench.metrics import _spans
from modcr_bench.tests import tiny

READERS = {"forward_host_ms.score": "step.eval", "collate_ms.score": "data.batch",
           "data_wait_ms.score": "data.wait"}


class CpuTracer:
    """A host-only capture over window steps [start, start + steps), as the
    harness's tracer opens its spans."""

    def __init__(self, start: int, steps: int):
        self.start, self.steps, self.prof = start, steps, None

    def step(self, i: int) -> None:
        if i == self.start:
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.__enter__()
        elif i == self.start + self.steps:
            self.finish(i)

    def finish(self, i: int) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None


@pytest.fixture(scope="module")
def run():
    """A tiny run of the cell with a host capture over window steps 1 and 2."""
    profiling.enable_spans(False)
    _fresh_spans_module()
    assert profiling.enable_spans(True)       # importing the readers switched them on
    profiling.reset_spans()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.manual_seed(0)
    c = tiny.cell("pmr_eval_b32")
    s = harness.load_module("traffic", c["runner"]).Session(
        c, tiny.configs()[c["config"]], 2**31 + 21, "cpu")
    s.setup()
    # the profiler's first start sets itself up (seconds): before the window
    with profile(activities=[ProfilerActivity.CPU]):
        torch.ones(1).add_(1)
    stats = s.window(5.0, CpuTracer(1, 2))
    s.release()
    torch.set_num_threads(threads)
    assert stats["steps"] >= 4
    yield s, harness.RunInfo(c, s.conf, s.model_dict, 0.0, stats, None)
    profiling.enable_spans(False)
    profiling.reset_spans()


def _fresh_spans_module(name: str = "_spans_again"):
    """``metrics/_spans.py`` imported anew, as a traced run's first import."""
    spec = importlib.util.spec_from_file_location(name, _spans.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(records):
    return statistics.fmean((r.end_ns - r.start_ns) / 1e6 for r in records)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_takes_the_windows_records_less_the_profiled(run, metric):
    session, info = run
    steps = info.stats["steps"]
    records = profiling.span_records(READERS[metric])
    window = records[-steps:]
    kept = [r for r in window if not r.profiled]
    assert len(kept) < len(window)             # the captured steps are left out
    value = harness.load_module("metrics", metric).read(info)
    assert value == pytest.approx(_ms(kept))


def test_the_window_leaves_out_the_warm_up(run):
    session, info = run
    steps = info.stats["steps"]
    evals = profiling.span_records("step.eval")
    assert len(evals) == steps + session.warm
    assert [r.profiled for r in evals].count(True) == 2
    assert all(not r.profiled for r in evals[:session.warm + 1])
    assert all(r.seq is None for r in evals)
    waits = profiling.span_records("data.wait")
    assert [r.seq for r in waits] == list(range(len(waits)))


def test_no_span_table_reads_nothing(run, monkeypatch):
    """At a program without ``span_records`` (the parent's profiling
    module) the readers return None, and nothing is switched on."""
    _, info = run
    old = types.ModuleType(profiling.__name__)
    old.start_trace = profiling.start_trace
    monkeypatch.setitem(sys.modules, profiling.__name__, old)
    monkeypatch.setattr(sys.modules["multimodal_context_reasoning_torch.utils"], "profiling",
                        old, raising=False)
    mod = _fresh_spans_module("_spans_at_the_parent")
    assert mod.profiling is None
    assert mod.window_mean_ms(info, "step.eval") is None
    empty = copy.copy(info)
    empty.stats = dict(info.stats, steps=0)
    assert _spans.window_mean_ms(empty, "step.eval") is None
