"""Where one full-width bf16 PMR training step spends its time, on the GPU.

    python scripts/torch_profile_train.py

Drives the PyTorch port's ``train_step`` in the training slice's
configuration (``core/config.py::pmr_training_config``: bf16, no alignment
loss, RoBERTa remat "full", dropout 0, encoders frozen; random weights from
a seed) at 32 examples (128 candidate rows) per step and reports:

- host: featurize and collate one batch (numpy), then copy it to the card;
- device: the step's time between CUDA events (forward, backward and the
  optimizer update), and the host wall time of the step up to a synchronize;
- ``torch.profiler``: device time per step by kernel, grouped into the three
  attention kernels, matrix products, the optimizer's fused updates and the
  rest, and the device's busy share of the step (kernel time over the step's
  span between CUDA events).

Needs a CUDA card; prints one JSON line last.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the port's package

from torch_profile_scorer import card_line, device_us  # noqa: E402

EXAMPLES = 32
REPS = 5
PROFILED = 2
GROUPS = {
    "spec_attention": ("spec_attention_kernel",),
    "dense_attention_forward": ("dense_attention_kernel",),
    "flash_backward": ("flash_bwd",),   # flash_bwd_mma_kernel (bf16), flash_bwd_kernel
    "matmul": ("gemm", "nvjet", "cutlass", "xmma", "cublas", "matmul"),
    "optimizer": ("multi_tensor_apply", "foreach"),
}


def group(name: str) -> str:
    low = name.lower()
    for key, needles in GROUPS.items():
        if any(n in low for n in needles):
            return key
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from multimodal_context_reasoning_torch.core.config import (
        TrainConfig,
        pmr_training_config,
    )
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
    from multimodal_context_reasoning_torch.train.state import TrainState
    from multimodal_context_reasoning_torch.train.step import train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    cfg = pmr_training_config()
    model = ModCRModel(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    state = TrainState.create(model, TrainConfig(), total_steps=100)
    n_steps = REPS + 2 + PROFILED + 1
    ds = synthetic_dataset(np.random.default_rng(0), EXAMPLES * n_steps, cfg)
    batches = iter(np.arange(EXAMPLES * n_steps).reshape(n_steps, EXAMPLES))

    host, copy, step_dev, step_wall = [], [], [], []
    for i in range(REPS + 2):
        t0 = time.perf_counter()
        batch = ds.batch(next(batches))
        t1 = time.perf_counter()
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        float(train_step(state, batch)["loss"])
        end.record()
        end.synchronize()
        t3 = time.perf_counter()
        if i >= 2:
            host.append(1e3 * (t1 - t0))
            copy.append(1e3 * (t2 - t1))
            step_dev.append(start.elapsed_time(end))
            step_wall.append(1e3 * (t3 - t2))

    profiled = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(next(batches)).items()}
                for _ in range(PROFILED)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in profiled:
            train_step(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    groups = dict.fromkeys([*GROUPS, "other"], 0.0)
    for e in kernels:
        groups[group(e.key)] += device_us(e) / (1e3 * PROFILED)
    step_ms = statistics.median(step_dev)
    top = sorted(kernels, key=device_us, reverse=True)[:15]
    out = dict(
        card=card, examples_per_step=EXAMPLES, rows_per_step=EXAMPLES * cfg.num_labels,
        host_featurize_ms=statistics.median(host), copy_ms=statistics.median(copy),
        step_device_ms=step_ms, step_wall_ms=statistics.median(step_wall),
        examples_per_s_device=EXAMPLES / step_ms * 1e3,
        device_ms_by_group_per_step=groups,
        # kernels on one stream do not overlap: their sum over the step's
        # span between CUDA events is the device's busy share of it
        device_busy_share_of_step=sum(groups.values()) / step_ms,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(json.dumps({k: v for k, v in out.items() if k != "card"}))
    for e in top:
        print(f"    {device_us(e) / (1e3 * PROFILED):8.3f} ms  "
              f"x{e.count / PROFILED:6.1f}  {e.key[:90]}")
    out["top_kernels"] = [dict(name=e.key[:90], ms_per_step=device_us(e) / (1e3 * PROFILED),
                               calls_per_step=e.count / PROFILED) for e in top]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
