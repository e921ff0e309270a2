"""Misc helpers (a copy of the JAX package's ``utils/misc.py``; reference
utils/misc.py)."""

from __future__ import annotations

import errno
import os
import random

import numpy as np
import torch


def mkdir(path: str) -> None:
    """mkdir -p (utils/misc.py:13-19)."""
    try:
        os.makedirs(path)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise


def set_seed(seed: int) -> "np.random.Generator":
    """Seed Python's, numpy's and torch's RNGs (CUDA's included, as the
    reference's utils/misc.py:21-27 does) and return a fresh numpy
    Generator."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)
