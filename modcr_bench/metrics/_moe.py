"""The routed experts' products in a traced span: their kernels by name,
and their bound (``lfm2_counts.py``)."""

from __future__ import annotations

from typing import Optional

from modcr_bench import lfm2_counts
from modcr_bench.metrics._lib import kernel_ms_per_step

# the kernels of ``torch._grouped_mm`` (bf16, sm_90): CUTLASS's grouped GEMM
EXPERT_KERNELS = ("groupproblemshape",)


def expert_ms(run) -> Optional[float]:
    """Device ms a step of the expert products."""
    return kernel_ms_per_step(run, *EXPERT_KERNELS)


def roofline_pct(run) -> Optional[float]:
    ms = expert_ms(run)
    if ms is None:
        return None
    bound = lfm2_counts.expert_bound_seconds(run.model, run.cell["traffic"]["questions_per_batch"])
    return 100.0 * bound / (ms / 1e3)
