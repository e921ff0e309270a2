"""Guards of the harness: nothing it loads is JAX's, the reference takes
nothing of the program, every cell resolves its files by name, a new
cell dropped in is found without an edit, the result line has the
required keys, and the command refuses to run without a card or
without the program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from modcr_bench import harness, run

BENCH = Path(harness.__file__).resolve().parent
CHECKOUT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multimodal_context_reasoning_tpu"}
PROGRAM = "multimodal_context_reasoning_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _python(code: str, cwd=CHECKOUT, env=None, timeout=600):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout, env=env)


def test_top_level_names_compare_whole():
    assert run.FORBIDDEN == FORBIDDEN
    sys.modules.setdefault("jaxlike_for_test", type(sys)("jaxlike_for_test"))
    try:
        assert "jaxlike_for_test" not in run.forbidden_modules()
    finally:
        sys.modules.pop("jaxlike_for_test", None)
    # the port's name begins with the JAX package's stem and is not it
    assert PROGRAM.split(".")[0] not in FORBIDDEN


def test_a_cpu_run_loads_no_jax():
    """Every module of the harness, each runner, reader and the reference,
    and one cell's whole run on the CPU: no forbidden top-level name."""
    code = (
        "import sys, json\n"
        "sys.path.insert(0, '.')\n"
        "from modcr_bench import harness, run, compare, counts, port, trace, weights, reference\n"
        "from modcr_bench.tests import tiny\n"
        "import pathlib\n"
        "for p in pathlib.Path('modcr_bench/traffic').glob('*.py'):\n"
        "    if p.stem != '__init__': harness.load_module('traffic', p.stem)\n"
        "for p in pathlib.Path('modcr_bench/metrics').glob('*.py'):\n"
        "    if not p.stem.startswith('_'): harness.load_module('metrics', p.stem)\n"
        "s, _ = tiny.session('pmr_eval_b32', seconds=0.2)\n"
        "s.check()\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {PROGRAM, "modcr_bench"}, (path.name, name)
    out = _python("import sys; sys.path.insert(0, '.'); import modcr_bench.reference; "
                  f"print(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN | {PROGRAM})!r}))")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_every_cell_resolves_by_name():
    bench = harness.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
        assert harness.load_config(cell["config"])["name"] == w["config"]
        assert (CHECKOUT / configs[w["config"]]["file"]).is_file()
        assert hasattr(harness.load_module("traffic", cell["runner"]), "Session")
        for trace in (False, True):
            metrics = harness.cell_metrics(bench, w["name"], trace)
            assert metrics
            for m in metrics:
                assert callable(harness.load_module("metrics", m["name"]).read)
        names = {m["name"] for m in harness.cell_metrics(bench, w["name"], False)}
        assert "setup_s" in names and len(names) >= 2
        assert set(cell["limits"])


def _copy_checkout(tmp_path: Path, with_program: bool = True) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(BENCH, root / "modcr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", root)
    if with_program:
        shutil.copytree(CHECKOUT / PROGRAM, root / PROGRAM,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return root


_RUN_TINY = (
    "import sys, json, time, torch\n"
    "sys.path.insert(0, '.')\n"
    "from modcr_bench import harness\n"
    "from modcr_bench.tests import tiny\n"
    "name = sys.argv[1]\n"
    "cell = harness.load_cell(name)\n"
    "cell['traffic'].update(pool=32, questions_per_batch=4)\n"
    "harness.load_config = lambda n: tiny.configs()[n]\n"
    "result, checks = harness.run_cell(name, cell, 2**31 + 3, 0.3, False, time.perf_counter(),"
    " torch.device('cpu'))\n"
    "print(json.dumps(result))\n")


def _run_tiny(root: Path, name: str):
    return subprocess.run([sys.executable, "-c", _RUN_TINY, name], cwd=root,
                          capture_output=True, text=True, timeout=600)


def test_a_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    root = _copy_checkout(tmp_path)
    cell = json.loads((root / "modcr_bench/workloads/pmr_eval_b32.json").read_text())
    cell["traffic"]["questions_per_batch"] = 8
    (root / "modcr_bench/workloads/tmp_cell_b8.json").write_text(json.dumps(cell))
    (root / "modcr_bench/metrics/tmp_rows.score.py").write_text(
        "def read(run):\n    return float(run.stats['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tmp_cell_b8", "config": "modcr_pmr",
                               "traffic": "evaluate_b8", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tmp_cell_b8")
    bench["per_layer"].append({"name": "tmp_rows.score", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "data/loader.py",
                               "moves": "score_ex_per_s", "workloads": ["tmp_cell_b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run_tiny(root, "tmp_cell_b8")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(result["metrics"]) == {"score_ex_per_s", "setup_s"}
    assert result["correct"] is True
    from modcr_bench.harness import cell_metrics
    assert [m["name"] for m in cell_metrics(bench, "tmp_cell_b8", True)][-1] == "tmp_rows.score"


def test_the_result_line_has_the_required_keys(tmp_path):
    """The five keys a result line has, then each number compared beside
    its limit under a key of its own, last."""
    out = _run_tiny(CHECKOUT, "pmr_eval_b32")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["checks"]["logits_off"]["limit"] >= result["checks"]["logits_off"]["value"]
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "modcr_bench/run.py", "--workload", "pmr_eval_b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    root = _copy_checkout(tmp_path, with_program=False)
    out = _run_tiny(root, "pmr_eval_b32")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert PROGRAM in out.stderr


def test_runs_write_only_inside_the_checkout(tmp_path):
    """A CPU run with a fresh HOME, XDG_CACHE_HOME and TMPDIR leaves them
    empty, and adds nothing to the checkout but ``__pycache__``."""
    root = _copy_checkout(tmp_path)
    dirs = {k: tmp_path / k.lower() for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR")}
    for d in dirs.values():
        d.mkdir()
    before = {p for p in root.rglob("*") if "__pycache__" not in p.parts}
    env = dict(os.environ, **{k: str(v) for k, v in dirs.items()})
    out = subprocess.run([sys.executable, "-c", _RUN_TINY, "pmr_eval_b32"], cwd=root,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    after = {p for p in root.rglob("*") if "__pycache__" not in p.parts}
    assert after == before
    for d in dirs.values():
        assert list(d.iterdir()) == [], d
