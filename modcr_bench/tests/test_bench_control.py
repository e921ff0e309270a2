"""The checks that decide ``correct`` must fail what is not correct.

- The control: the configuration's precision (bf16) one step lower, the
  program's own W8A8 int8 route.
- Faults planted under a whole run of a cell (its set-up, window and
  check, skipping only the look for a card): half of the batch left out,
  an answer altered where it is produced.  Scoring keeps no state, and one
  card has no exchange to leave out.

On the CPU at tiny widths each must read above the cell's limit.  Marked
``cuda``, the same readings at the cell's own size, printed for PERF.md:

    python -m pytest modcr_bench/tests/test_bench_control.py -m cuda -s
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from modcr_bench import harness
from modcr_bench.tests import tiny
from modcr_bench.trace import Tracer

SEEDS = [int(s) for s in os.environ.get("BENCH_CONTROL_SEEDS",
                                        "2147483911,2147483912,2147483913").split(",")]


def _half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def half_eval(eval_step):
    def step(model, batch):
        out = eval_step(model, _half(batch))
        return {**out, "logits": torch.cat([out["logits"], out["logits"]])}
    return step


def altered_eval(eval_step):
    """One answer in eight altered: its first logit raised by 0.5."""
    def step(model, batch):
        out = eval_step(model, batch)
        logits = out["logits"].clone()
        logits[::8, 0] += 0.5
        return {**out, "logits": logits}
    return step


FAULTS = {"evaluate": {"eval_step": [half_eval, altered_eval]}}
SCORE = ["pmr_eval_b32"]


def run_session(cell, conf, seed, device, seconds, fault=None):
    """Set-up, window, release and check of ``cell`` with ``fault``
    (name, wrapper) planted in its runner."""
    drv = harness.load_module("traffic", cell["runner"])
    saved = None
    if fault is not None:
        name, wrap = fault
        saved = getattr(drv, name)
        setattr(drv, name, wrap(saved))
    try:
        s = drv.Session(cell, conf, seed, device)
        s.setup()
        s.window(seconds, Tracer(False))
        s.release()
        return s.check()
    finally:
        if saved is not None:
            setattr(drv, fault[0], saved)


def _fails(cell, values):
    return any(values[n] > limit for n, limit in cell["limits"].items())


# --- CPU, tiny widths ------------------------------------------------------

@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", SCORE)
def test_scoring_control_fails(name):
    c = tiny.cell(name, quantize="int8")
    sound = run_session(tiny.cell(name), tiny.configs()["modcr_pmr"], 5, "cpu", 0.3)
    control = run_session(c, tiny.configs()["modcr_pmr"], 5, "cpu", 0.3)
    assert not _fails(c, sound)
    assert _fails(c, control)
    assert control["logit_gap"] > 30 * sound["logit_gap"]


@pytest.mark.parametrize("name, fault", [
    (name, (fn, wrap)) for name in SCORE
    for fn, wraps in FAULTS[harness.load_cell(name)["runner"]].items() for wrap in wraps],
    ids=lambda v: v if isinstance(v, str) else v[1].__name__)
def test_a_planted_fault_fails_the_run(name, fault):
    c = tiny.cell(name)
    values = run_session(c, tiny.configs()[c["config"]], 7, "cpu", 0.3, fault)
    assert _fails(c, values), values


# --- on the card, at the cells' own sizes ------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _report(kind, name, seed, values):
    print("READING " + json.dumps({"kind": kind, "cell": name, "seed": seed, **values}), flush=True)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SCORE)
def test_scoring_control_on_the_card(name, seed):
    dev = _card()
    c = harness.load_cell(name)
    c["traffic"]["quantize"] = "int8"
    values = run_session(c, harness.load_config("modcr_pmr"), seed, dev, 3.0)
    _report("control", name, seed, values)
    assert _fails(c, values)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SCORE)
def test_faults_on_the_card(name, seed):
    dev = _card()
    c = harness.load_cell(name)
    for fn, wraps in FAULTS[c["runner"]].items():
        for wrap in wraps:
            values = run_session(c, harness.load_config(c["config"]), seed, dev, 1.0,
                                 (fn, wrap))
            _report(wrap.__name__, name, seed, values)
            assert _fails(c, values)
