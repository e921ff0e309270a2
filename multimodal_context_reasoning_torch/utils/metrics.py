"""Windowed training metrics (the part of the JAX package's
``utils/metrics.py`` that the trainer and utils/tensorboard.py use).

Rebuilds ``utils/metric_logger.py``: SmoothedValue (window median and global
average, :11-44) and MetricLogger (grouped meters with a delimiter-joined
__str__, :47-112).  The trainer feeds it host floats at its synchronization
points.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict


class SmoothedValue:
    """Track a series with a windowed median and a global average."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value) -> None:
        value = float(value)
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        mid = n // 2
        return d[mid] if n % 2 else 0.5 * (d[mid - 1] + d[mid])

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def last(self) -> float:
        return self.deque[-1] if self.deque else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  ", window_size: int = 20):
        self.meters: Dict[str, SmoothedValue] = defaultdict(
            lambda: SmoothedValue(window_size)
        )
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(v)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items()
        )
