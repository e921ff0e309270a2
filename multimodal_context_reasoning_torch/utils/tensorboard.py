"""TensorBoard metric writer (a copy of the JAX package's
``utils/tensorboard.py``).

Rebuilds ``utils/metric_logger.py:115-185`` (TensorboardLogger): three
writer namespaces, last value, windowed average and windowed median, over a
MetricLogger's meters.  It writes through ``torch.utils.tensorboard`` when
that imports (it needs the ``tensorboard`` package), and otherwise to a
JSONL file with the same triple, as the JAX module does.  The trainer
imports this module only when it is given a ``tensorboard_dir``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from multimodal_context_reasoning_torch.utils.metrics import MetricLogger


class TensorboardLogger:
    def __init__(self, log_dir: str, start_step: int = 0):
        self.step = start_step
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._last = self._avg = self._med = None
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        else:
            self._last = SummaryWriter(os.path.join(log_dir, "last"))
            self._avg = SummaryWriter(os.path.join(log_dir, "avg"))
            self._med = SummaryWriter(os.path.join(log_dir, "median"))

    @property
    def writer(self) -> str:
        """Which branch writes: ``"SummaryWriter"`` or ``"jsonl"``."""
        return "jsonl" if self._jsonl is not None else "SummaryWriter"

    def log_scalar(self, name: str, value: float, step: Optional[int] = None) -> None:
        step = self.step if step is None else step
        if self._last is not None:
            self._last.add_scalar(name, value, step)
        else:
            self._jsonl.write(json.dumps(
                {"t": time.time(), "step": step, name: float(value)}) + "\n")

    def log_meters(self, meters: MetricLogger, step: Optional[int] = None) -> None:
        step = self.step if step is None else step
        for name, m in meters.meters.items():
            if self._last is not None:
                self._last.add_scalar(name, m.last, step)
                self._avg.add_scalar(name, m.avg, step)
                self._med.add_scalar(name, m.median, step)
            else:
                self._jsonl.write(json.dumps({
                    "t": time.time(), "step": step, "name": name,
                    "last": m.last, "avg": m.avg, "median": m.median,
                }) + "\n")
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        for w in (self._last, self._avg, self._med):
            if w is not None:
                w.close()
        if self._jsonl is not None:
            self._jsonl.close()
