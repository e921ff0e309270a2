"""Process-0-gated logging (a copy of the JAX package's
``utils/logging.py``).

Rebuilds ``utils/logger.py`` (setup_logger, :83-101): file + stdout handlers
attached only on process 0, with an optional reopen-per-emit file handler for
fuse-mounted blob stores (the reference's comment at utils/logger.py:9-12).
The port runs one process, so the process index defaults to 0.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


class ReopenFileHandler(logging.StreamHandler):
    """Re-opens the file for every record — safe on fuse/blob mounts
    (utils/logger.py:13-42)."""

    def __init__(self, filename: str, mode: str = "a"):
        self.filename = filename
        self.mode = mode
        super().__init__(self._open())

    def _open(self):
        return open(self.filename, self.mode, encoding="utf-8")

    def emit(self, record):
        self.stream = self._open()
        try:
            super().emit(record)
            self.stream.flush()
        finally:
            self.stream.close()


def setup_logger(
    name: str,
    save_dir: Optional[str] = None,
    process_index: int = 0,
    filename: str = "log.txt",
    *,
    reopen_per_emit: bool = False,
) -> logging.Logger:
    """Create a logger; non-zero processes get no handlers (rank gating,
    utils/logger.py:88-90)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if process_index > 0:
        return logger
    if logger.handlers:
        return logger

    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    sh = logging.StreamHandler(sys.stdout)
    sh.setLevel(logging.DEBUG)
    sh.setFormatter(fmt)
    logger.addHandler(sh)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, filename)
        fh = ReopenFileHandler(path) if reopen_per_emit else logging.FileHandler(path)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
