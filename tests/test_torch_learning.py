"""Learning integration of the PyTorch port, the twin of the JAX package's
``tests/test_learning.py::test_overfits_fixed_batch``: the whole ModCR
training stack overfits a tiny separable problem, evidence that gradients
reach the decision through the prefix path (the only trainable route from
the image to the decision).  The same tiny config, batch (the JAX test's
``make_batch``, seed 3) and optimizer settings, the same assertions."""

import numpy as np
import torch

from multimodal_context_reasoning_torch.core.config import ModCRConfig, TrainConfig
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.train.step import train_step
from tests.test_models import make_batch


def test_overfits_fixed_batch():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = ModCRConfig.tiny()
        model = ModCRModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in make_batch(cfg, n_examples=2, seed=3).items()}
        tcfg = TrainConfig(learning_rate=3e-3, scheduler="constant", warmup_steps=0,
                           gradient_accumulation_steps=1, weight_decay=0.0)
        state = TrainState.create(model, tcfg, total_steps=200)
        torch.manual_seed(1)   # the mapping networks' dropout draws
        first = last = None
        for i in range(60):
            m = train_step(state, batch)
            if i == 0:
                first = float(m["loss"])
            last = float(m["loss"])
        acc = float(m["correct"]) / float(m["count"])
    finally:
        torch.set_num_threads(threads)
    assert last < first * 0.5, (first, last)
    assert acc == 1.0, acc
