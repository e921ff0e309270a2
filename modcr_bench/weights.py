"""Weights of a run, made from ``--seed`` on the device in one draw: one
``torch.randn`` over every parameter's elements from a ``torch.Generator``
on the device, then each parameter's slice scaled by its kind.  The same
seed on the same device gives the same weights, so the reference makes
them again instead of taking them from the program.

- embeddings: N(0, 0.02);
- dense weights [out, in]: N(0, 1/in) (lecun);
- biases: N(0, 0.02) and not zero, so that a dropped bias shows;
- LayerNorm: weight 1 + N(0, 0.05), bias N(0, 0.02).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .reference import params

INIT_STD = 0.02
NORM_STD = 0.05


def _dense(name: str, shape) -> bool:
    return len(shape) == 2 and "embeddings" not in name and "edge_dense" not in name


def make(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor (views of one buffer) for every entry of
    ``shapes``."""
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    with torch.no_grad():
        for name, shape in shapes:
            n = math.prod(shape)
            out[name] = t = flat[offset:offset + n].view(shape)
            if "LayerNorm" in name and name.endswith(".weight"):
                t.mul_(NORM_STD).add_(1.0)
            elif _dense(name, shape):
                t.mul_(1.0 / math.sqrt(shape[1]))
            else:
                t.mul_(INIT_STD)
            offset += n
    return out


def for_model(conf: Dict, m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights of configuration ``conf`` run at model dict ``m``."""
    return make(params.SHAPES[conf["kind"]](m), seed, device)
