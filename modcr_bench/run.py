"""Run one benchmark cell once on this machine's GPU and print its result.

    python3 modcr_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell's file ``workloads/<cell>.json``
names its configuration (``configs/<config>.json``) and its traffic runner
(``traffic/<runner>.py``); ``BENCHMARK.json`` at the checkout's root says
which metrics the cell reports, each read by ``metrics/<metric>.py``.
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (from a profiled span of the window).

After the window the program's state is freed and the plain fp32
reference checks what the timed path produced; each number compared is
printed beside its limit, last on standard error and last in the line.
The run fails without a result when there is no CUDA card (or fewer than
the cell asks for), and when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
# caches at fixed places inside the checkout, so only a checkout's first
# run builds; nothing under a shared /tmp path
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multimodal_context_reasoning_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    one of its libraries' or the JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def fail(msg: str, code: int = 2):
    print(f"modcr_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from modcr_bench import harness  # noqa: E402

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the GPU and has no CPU fallback")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} GPUs, {torch.cuda.device_count()} visible")
    torch.set_num_threads(2)
    result, checks = harness.run_cell(args.workload, cell, args.seed, args.seconds,
                                      bool(args.trace), T_START, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        fail(f"JAX or the JAX package was loaded in this process: {', '.join(found)}")
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
