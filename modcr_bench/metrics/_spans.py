"""Readers of the program's own spans (``utils/profiling.py``).  Importing
this module switches the program's spans on: the harness imports a cell's
readers only for a traced run, before its set-up, so untraced runs keep
them off.  Where the program has no span table, the readers read nothing."""

from __future__ import annotations

import statistics
from typing import Optional

try:
    from multimodal_context_reasoning_torch.utils import profiling
except ImportError:
    profiling = None
if profiling is not None and not hasattr(profiling, "span_records"):
    profiling = None
if profiling is not None:
    profiling.enable_spans(True)


def window_mean_ms(run, name: str) -> Optional[float]:
    """Mean ms of the window's spans ``name``: the last ``steps`` records,
    less those taken under the profiler (the traced steps)."""
    if profiling is None:
        return None
    steps = run.stats["steps"]
    records = profiling.span_records(name)[-steps:] if steps > 0 else []
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in records if not r.profiled]
    return statistics.fmean(ms) if ms else None
