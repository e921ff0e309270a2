"""Build of the port's CUDA kernels at first use.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` into a shared library under ``build/torch_kernels/``
beside the package (a directory ``.gitignore`` lists), named by a hash of the
source and of every shared header ``csrc/*.cuh`` (``common.cuh``,
``attention_mma.cuh``), so an edit to a source or to any header rebuilds every
library that may include it, and an unchanged one is loaded as it is.
Nothing here runs at import: the wrappers call :func:`load_library` on their
first CUDA launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

from multimodal_context_reasoning_torch.utils.profiling import count

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> (library, nvcc output, build seconds); one load per process
_LOADED: Dict[str, Tuple[ctypes.CDLL, str, float]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def source_digest(src: Path) -> str:
    """Rebuild key of one kernel source: a hash of it and of every header in
    ``csrc/``, in name order."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str) -> Tuple[ctypes.CDLL, str, float]:
    """Compile ``csrc/<name>.cu`` unless its library is already built, load
    it, and return ``(library, nvcc output, seconds spent building)``.
    Raises ``RuntimeError`` with the compiler's output if the build fails."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    digest = source_digest(src)
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    log, seconds = "", 0.0
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
        t0 = time.perf_counter()
        count("ops.builds")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, lib_path)
    _LOADED[name] = (ctypes.CDLL(str(lib_path)), log, seconds)
    return _LOADED[name]
