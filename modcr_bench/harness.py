"""The harness behind ``run.py``: finds a cell's files by name, runs its
traffic runner's set-up, window and check, reads the metrics the cell
reports and builds the result line.

A traffic runner ``traffic/<runner>.py`` defines ``Session(cell, conf,
seed, device)`` with

- ``setup()``: build the program's objects, make the traffic, warm up
  every shape the window uses;
- ``window(seconds, tracer) -> stats``: the timed loop, ending with a
  device synchronise; ``stats`` holds ``seconds``, ``steps``,
  ``attempted``, ``failed`` and the counts its metrics read;
- ``release()``: free the program's state;
- ``check() -> {name: value}``: run the reference and compare.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Dict:
    path = BENCH / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"modcr_bench: no workload file {path.relative_to(CHECKOUT)}")
    return load_json(path)


def load_config(name: str) -> Dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, imported by its path (a
    metric's name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    mod_name = f"modcr_bench.{kind}._by_name_{name.replace('.', '__').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise SystemExit(f"modcr_bench: no {kind} file {path.relative_to(CHECKOUT)}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a cell reports: its end-to-end metrics (those with no
    ``workloads`` list, or listing the cell), or with ``trace`` its
    per-layer ones (those listing the cell, or without a list those whose
    ``moves`` the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


class RunInfo:
    """What a metric reader reads."""

    def __init__(self, cell: Dict, conf: Dict, model: Dict, setup_s: float, stats: Dict, trace):
        self.cell, self.conf, self.model = cell, conf, model
        self.setup_s, self.stats, self.trace = setup_s, stats, trace


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e30


def run_cell(name: str, cell: Dict, seed: int, seconds: float, trace: bool, t_start: float,
             device) -> Tuple[Dict, Dict[str, Tuple[float, float]]]:
    import torch

    from modcr_bench.trace import Tracer

    conf = load_config(cell["config"])
    bench = benchmark()
    readers = [(m, load_module("metrics", m["name"])) for m in cell_metrics(bench, name, trace)]
    session = load_module("traffic", cell["runner"]).Session(cell, conf, seed, device)
    session.setup()
    tr = cell.get("trace", {})
    tracer = Tracer(trace, tr.get("start", 1), tr.get("steps", 4))
    setup_s = time.perf_counter() - t_start
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    stats = session.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = tracer.summary()
    tracer.prof = []
    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    values = session.check()
    limits = cell["limits"]
    checks = {n: (_finite(values[n]), lim) for n, lim in limits.items()}
    correct = all(v <= lim for v, lim in checks.values()) and stats["steps"] > 0
    for n, v in values.items():
        if n not in limits:
            print(f"info {n} {v!r} (not compared)", file=sys.stderr)

    run = RunInfo(cell, conf, session.model_dict, setup_s, stats, summary)
    metrics = {}
    for m, reader in readers:
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": stats["attempted"], "failed": stats["failed"],
              "metrics": metrics, "device": dev}
    if cuda:
        print(f"card {power_limit()}; set-up {session.phases.seconds}; "
              f"{stats['steps']} steps in {stats['seconds']:.3f} s", file=sys.stderr)
    if stats.get("step_s"):
        q = statistics.quantiles(stats["step_s"], n=10) if len(stats["step_s"]) > 1 else [0] * 9
        print(f"host seconds a step: p10 {q[0]:.4f} p50 {q[4]:.4f} p90 {q[8]:.4f} "
              f"max {max(stats['step_s']):.4f}", file=sys.stderr)
    if summary is not None:
        pace = f"{summary.steps * summary.pace_s:.3f}" if summary.pace_s else "no"
        print(f"traced span: {summary.steps} steps in {summary.span_s:.4f} s ({pace} s at the "
              f"untraced steps' pace), busy {summary.busy_s:.4f} s, "
              f"{summary.strays} device events outside it left out", file=sys.stderr)
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.span_s
        top = sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, s] for k, s in top],
                               "idle_gaps": [[k, s] for k, s in summary.gaps[:10]]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    return result, checks
