"""PyTorch port: the program's spans and counters (``utils/profiling.py``)
and where they are put: the recorder off and on, nesting, threads, the
ring, the ``profiled`` mark and the clock under a CPU ``torch.profiler``
capture, ``device_time_by_span`` on hand-made intervals, the loader's,
eval step's and model stages' spans on a tiny CPU model, and the export
path of ``serving/aot.py`` with spans on.  JAX-free."""

import importlib.util
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.serving import aot
from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
from multimodal_context_reasoning_torch.train.step import eval_step
from multimodal_context_reasoning_torch.utils import profiling
from multimodal_context_reasoning_torch.utils.profiling import (
    OUTSIDE,
    SpanRecord,
    count,
    counter,
    device_time_by_span,
    enable_spans,
    reset_spans,
    span,
    span_records,
    span_table,
    write_spans,
)


@pytest.fixture(autouse=True)
def fresh_spans():
    """Each test starts with spans off and none recorded, and leaves them so."""
    was = enable_spans(False)
    reset_spans()
    yield
    enable_spans(was)
    reset_spans()


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    cfg = ModCRConfig.tiny()
    ds = synthetic_dataset(np.random.default_rng(0), 8, cfg)
    model = ModCRModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return cfg, ds, model


def test_off_records_nothing_and_returns_the_shared_no_op():
    first, second = span("a"), span("b", seq=3)
    assert first is second
    with first as s:
        assert s is None
    assert span_table()["spans"] == {} and span_records("a") == []
    assert isinstance(span_records("a"), list)


def test_nesting_gives_parents_and_self_times():
    enable_spans(True)
    with span("outer"):
        time.sleep(0.01)
        with span("inner", seq=7):
            time.sleep(0.02)
    (outer,), (inner,) = span_records("outer"), span_records("inner")
    assert outer.parent is None and inner.parent == "outer"
    assert inner.seq == 7 and outer.seq is None
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    table = span_table()["spans"]
    assert table["outer"]["count"] == 1 and table["inner"]["count"] == 1
    assert table["outer"]["self_ms"] == pytest.approx(
        table["outer"]["total_ms"] - table["inner"]["total_ms"])
    assert table["inner"]["self_ms"] == table["inner"]["total_ms"] >= 20.0
    assert 10.0 <= table["outer"]["self_ms"] < table["outer"]["total_ms"]
    assert table["outer"]["median_ms"] == table["outer"]["total_ms"]


def test_two_threads_keep_separate_stacks_and_share_seq():
    enable_spans(True)
    inside = threading.Event()
    done = threading.Event()

    def other():
        with span("producer", seq=5):
            inside.set()
            done.wait(5)

    t = threading.Thread(target=other)
    t.start()
    inside.wait(5)
    with span("consumer", seq=5):
        pass
    done.set()
    t.join()
    (p,), (c,) = span_records("producer"), span_records("consumer")
    # the consumer ran while the producer's span was open, on another stack
    assert c.parent is None and p.parent is None
    assert p.thread != c.thread == threading.get_ident()
    assert p.seq == c.seq == 5


def test_the_ring_stays_bounded_and_totals_run_on(monkeypatch):
    enable_spans(True)
    monkeypatch.setattr(profiling, "RING", 16)
    for i in range(50):
        with span("many", seq=i):
            pass
    records = span_records("many")
    assert len(records) == 16 and [r.seq for r in records] == list(range(34, 50))
    assert span_table()["spans"]["many"]["count"] == 50


def test_counters_are_always_on_and_outlast_a_reset():
    before = counter("test.counter")
    count("test.counter")
    count("test.counter", 4)
    reset_spans()
    assert counter("test.counter") == before + 5
    assert span_table()["counters"]["test.counter"] == before + 5


def test_profiled_is_set_under_a_cpu_capture_from_the_loader_thread_too(tiny):
    _, ds, _ = tiny
    enable_spans(True)
    loader = DataLoader(ds, 1)            # prefetch: batches made on a thread
    it = iter(loader)
    next(it)
    with profile(activities=[ProfilerActivity.CPU]):
        next(it)
        next(it)
        time.sleep(0.3)                   # the producer makes the next batch
    next(it)
    batches = span_records("data.batch")
    assert {r.thread for r in batches} != {threading.get_ident()}
    waits = span_records("data.wait")
    assert [r.seq for r in waits] == [0, 1, 2, 3]
    assert [r.profiled for r in waits] == [False, True, True, False]
    assert any(r.profiled for r in batches) and not batches[0].profiled


def test_the_clock_is_the_captures():
    """A span's start lies within 200 us of its own record_function event
    in a CPU capture, at ``trace_start_ns() + start_us * 1000``."""
    enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(6):
            with span(f"clock.{i}"):
                torch.ones(4).add_(1)
    res = prof.profiler.kineto_results
    starts = {e.name: res.trace_start_ns() + e.time_range.start * 1000
              for e in prof.events() if e.name.startswith("clock.")}
    assert len(starts) == 6
    for i in range(1, 6):      # the first record_function of a process sets itself up
        (rec,) = span_records(f"clock.{i}")
        assert rec.profiled
        assert abs(starts[f"clock.{i}"] - rec.start_ns) < 200_000, i


def _rec(name, a, b, parent=None):
    return SpanRecord(name, a, b, parent, 1, None, False)


def test_device_time_by_span_gives_every_gap():
    """Window [0, 100): spans step [10, 90) holding model [20, 60); kernels
    (start, end, launch).  Every gap goes to the innermost span open at its
    start, every kernel to the one open at its launch."""
    records = [_rec("step", 10, 90), _rec("model", 20, 60, "step"), _rec("wait", 92, 99)]
    kernels = [(5, 15, 2), (12, 18, 11), (25, 30, 21), (30, 40, 22), (70, 80, 55),
               (95, 97, None)]
    out = device_time_by_span(kernels, 0, 100, records)
    # gaps: [0,5) outside, [18,25) step, [40,70) model, [80,95) step, [97,100) wait
    assert out[OUTSIDE]["idle_s"] == pytest.approx(5e-9)
    assert out["step"]["idle_s"] == pytest.approx(22e-9)
    assert out["model"]["idle_s"] == pytest.approx(30e-9)
    assert out["wait"]["idle_s"] == pytest.approx(3e-9)
    busy = 10 + 3 + 15 + 10 + 2      # the union of the kernels
    assert sum(v["idle_s"] for v in out.values()) == pytest.approx((100 - busy) * 1e-9)
    # kernels: launch 2 outside; 11 step; 21, 22, 55 model; unknown launch outside
    assert out[OUTSIDE]["kernel_s"] == pytest.approx(12e-9)
    assert out["step"]["kernel_s"] == pytest.approx(6e-9)
    assert out["model"]["kernel_s"] == pytest.approx(25e-9)
    assert out["wait"]["kernel_s"] == 0.0


def test_device_time_by_span_clips_to_the_window_and_sums_to_span_less_busy():
    rng = np.random.default_rng(0)
    starts = np.sort(rng.integers(0, 10_000, 200))
    kernels = [(int(a), int(a + rng.integers(1, 80)), int(a) - 3) for a in starts]
    records = [_rec("s", i * 500, i * 500 + 300) for i in range(20)]
    w0, w1 = 1_000, 9_000
    out = device_time_by_span(kernels, w0, w1, records)
    covered = np.zeros(w1 - w0, bool)
    for a, b, _ in kernels:
        covered[max(a, w0) - w0:max(min(b, w1) - w0, 0)] = True
    idle = sum(v["idle_s"] for v in out.values())
    assert idle == pytest.approx((w1 - w0 - covered.sum()) * 1e-9)
    assert sum(v["kernel_s"] for v in out.values()) >= covered.sum() * 1e-9


def test_loader_eval_step_and_model_stage_spans_on_a_tiny_model(tiny, tmp_path):
    cfg, _, model = tiny
    ds = synthetic_dataset(np.random.default_rng(1), 8, cfg)   # nothing memoized yet
    enable_spans(True)
    loader = DataLoader(ds, 2)
    for batch in loader:
        eval_step(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    n = len(loader)
    for name in ("data.batch", "data.wait", "step.eval", "model.vision_prefix",
                 "model.alignment", "model.roberta", "model.score", "data.collate"):
        assert len(span_records(name)) == n, name
    assert [r.seq for r in span_records("data.batch")] == list(range(n))
    assert [r.seq for r in span_records("data.wait")] == list(range(n))
    assert {r.parent for r in span_records("model.alignment")} == {"step.eval"}
    assert {r.parent for r in span_records("data.collate")} == {"data.batch"}
    assert len(span_records("data.featurize")) == len(ds)   # memo: each example once
    # a second epoch numbers on and hits the memo
    hits = counter("data.memo_hit")
    list(loader)
    assert [r.seq for r in span_records("data.wait")][n:] == list(range(n, 2 * n))
    assert counter("data.memo_hit") == hits + len(ds)
    assert len(span_records("data.featurize")) == len(ds)
    table = write_spans(str(tmp_path / "spans.json"))
    assert table["spans"]["step.eval"]["count"] == n
    assert os.path.getsize(tmp_path / "spans.json") > 0


class _SlowDataset:
    def __len__(self):
        return 3

    def batch(self, idx):
        time.sleep(0.05)
        return {"x": np.asarray(idx)}


def test_a_get_that_finds_the_queue_empty_is_counted():
    before = counter("data.queue_empty")
    assert len(list(DataLoader(_SlowDataset(), 1))) == 3
    assert counter("data.queue_empty") == before + 3


def test_the_plain_attention_path_is_counted(tiny):
    cfg, ds, model = tiny
    batch = {k: torch.from_numpy(v) for k, v in ds.batch([0, 1]).items()}
    before = counter("attention.plain.probs")
    eval_step(model, batch)
    # alignment on: the cross layers return their probabilities
    assert counter("attention.plain.probs") > before


def test_aot_export_traces_the_same_graph_with_spans_on(tiny, tmp_path):
    _, ds, model = tiny
    batch = {k: torch.from_numpy(v) for k, v in ds.batch([0, 1]).items()
             if k not in ("label", "example_mask")}
    graphs = []
    for on in (False, True):
        enable_spans(on)
        d = str(tmp_path / str(on))
        aot._export(d, aot.PROGRAM_FILE, model, aot._scorer_forward, (batch,))
        graphs.append(str(torch.export.load(os.path.join(d, aot.PROGRAM_FILE)).graph))
    assert graphs[0] == graphs[1]
    assert span_records("model.alignment") == []    # nothing recorded while tracing


def test_chip_smoke_zeroes_and_restores_the_launch_counts():
    """``chip_smoke.py`` writes the launchers' ``launches``: zeroed before a
    phase, put back after a comparison with the plain version."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    wrappers = smoke.wrappers()
    before = smoke.read_counts()
    try:
        smoke.reset_counts()
        assert smoke.read_counts() == dict.fromkeys(wrappers, 0)
        count("ops.spec_attention.launches", 3)
        with smoke.uncounted():
            count("ops.spec_attention.launches", 5)
            count("ops.flash_bwd.launches")
        assert smoke.read_counts() == {"spec_attention": 3, "fused_attention": 0,
                                       "flash_bwd": 0}
        assert counter("ops.spec_attention.launches") == 3
    finally:
        for name, w in wrappers.items():
            w.launches = before[name]
