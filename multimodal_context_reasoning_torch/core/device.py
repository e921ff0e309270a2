"""The device an entry point runs on: the GPU unless the caller asks for the
CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it is CUDA and there is
    no CUDA card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
