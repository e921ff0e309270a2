"""Profiling hooks (port of the JAX package's ``utils/profiling.py``).

:func:`trace` is a ``torch.profiler`` capture, with CUDA activity when the
card is there, that writes a Chrome trace into ``log_dir``; :class:`StepTimer`
synchronises the device before it reads the clock, since PyTorch returns
before the card has finished.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def activities(device: Optional[torch.device] = None) -> list:
    """What a capture records: the host's ops, and the card's kernels when
    ``device`` (default: any card present) is CUDA."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available() if device is None else device.type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def synchronize(device: Optional[torch.device] = None) -> None:
    """Wait for the card (``device``, default: any card present) to finish
    its queued work; nothing to wait for on the CPU."""
    cuda = torch.cuda.is_available() if device is None else device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)


def start_trace(device: Optional[torch.device] = None) -> torch.profiler.profile:
    """A started ``torch.profiler.profile``; :func:`stop_trace` ends it."""
    prof = torch.profiler.profile(activities=activities(device))
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str,
               device: Optional[torch.device] = None) -> str:
    """Stop ``prof`` (after the card has finished the captured work) and
    write its Chrome trace into ``log_dir``; returns the file's path."""
    synchronize(device)
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str],
          device: Optional[torch.device] = None) -> Iterator[Optional[torch.profiler.profile]]:
    """Capture what runs inside into a Chrome trace under ``log_dir``
    (viewable in ``chrome://tracing`` or Perfetto); yields the profile, or
    does nothing and yields None when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    prof = start_trace(device)
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir, device)


class StepTimer:
    """Wall-clock step timer that synchronises the device before it reads
    the clock, so a step's time is the card's work and not its enqueue."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.t0: Optional[float] = None
        self.elapsed: float = 0.0
        self.steps: int = 0

    def start(self) -> None:
        synchronize(self.device)
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        synchronize(self.device)
        dt = time.perf_counter() - self.t0
        self.elapsed += dt
        self.steps += 1
        return dt

    def rate(self, items_per_step: int) -> float:
        return items_per_step * self.steps / self.elapsed if self.elapsed else 0.0
