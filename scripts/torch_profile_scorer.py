"""Where one full-width bf16 scoring micro-batch spends its time, on the GPU.

    python scripts/torch_profile_scorer.py

Drives the PyTorch port's ``ModCRScorer`` (``ModCRConfig()`` in bf16,
``compute_alignment=False``, random weights from a seed) at micro-batch 8
and 32 and reports, per micro-batch:

- host: featurize (numpy), then collate and copy the batch to the card;
- device: the forward's time between CUDA events, and the host wall time of
  the forward up to a synchronize;
- ``torch.profiler``: device time by kernel, grouped into the stage-mask
  attention kernel, matrix products and the rest, and the device's busy
  share of the forward (kernel time over the forward's span between CUDA
  events; the profiled window's share is lower by the profiler's cost).

Needs a CUDA card; prints one JSON line last.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the port's package

REPS = 10


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _group(name: str) -> str:
    low = name.lower()
    if "spec_attention" in low:
        return "spec_attention"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas", "matmul")):
        return "matmul"
    return "other"


def profile(scorer, feats) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    batch = scorer.device_batch(feats)
    with torch.inference_mode():
        scorer.model(batch)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                scorer.model(batch)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {"spec_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        groups[_group(e.key)] += _device_us(e) / 3e3
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    busy = sum(_device_us(e) for e in kernels)
    return dict(
        device_ms_by_group_per_forward=groups,
        device_busy_share_profiled=busy / wall_us if wall_us else None,
        top_kernels=[dict(name=e.key[:90], ms_per_forward=_device_us(e) / 3e3,
                          calls_per_forward=e.count / 3) for e in top],
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_scorer: no CUDA card", file=sys.stderr)
        return 2
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.scorer import (
        ModCRScorer,
        pad_by_repetition,
    )
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    cfg = dataclasses.replace(ModCRConfig(), compute_alignment=False).with_dtype("bfloat16")
    model = ModCRModel(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    bert, rob = hash_tokenizers(cfg)
    rng = np.random.default_rng(0)
    out = {"card": card}
    for mb in (8, 32):
        images, reqs = synthetic_requests(rng, mb, cfg)
        scorer = ModCRScorer(cfg, model, bert, rob, images, micro_batch=mb, device="cuda")
        host, copy, fwd_dev, fwd_wall = [], [], [], []
        with torch.inference_mode():
            for i in range(REPS + 2):
                t0 = time.perf_counter()
                feats = pad_by_repetition([scorer.featurize(ex) for ex in reqs], mb)[1]
                t1 = time.perf_counter()
                batch = scorer.device_batch(feats)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                scorer.model(batch).logits.float().cpu()
                end.record()
                end.synchronize()
                t3 = time.perf_counter()
                if i >= 2:
                    host.append(1e3 * (t1 - t0))
                    copy.append(1e3 * (t2 - t1))
                    fwd_dev.append(start.elapsed_time(end))
                    fwd_wall.append(1e3 * (t3 - t2))
        row = dict(
            rows=mb * cfg.num_labels,
            host_featurize_ms=statistics.median(host),
            collate_and_copy_ms=statistics.median(copy),
            forward_device_ms=statistics.median(fwd_dev),
            forward_wall_ms=statistics.median(fwd_wall),
        )
        row.update(profile(scorer, feats))
        # kernels on one stream do not overlap: their sum over the forward's
        # span between CUDA events is the device's busy share of it
        row["device_busy_share_of_forward"] = (
            sum(row["device_ms_by_group_per_forward"].values()) / row["forward_device_ms"])
        out[f"micro_batch_{mb}"] = row
        print(f"micro_batch {mb}: " + json.dumps(
            {k: v for k, v in row.items() if k != "top_kernels"}))
        for k in row["top_kernels"]:
            print(f"    {k['ms_per_forward']:8.3f} ms  x{k['calls_per_forward']:5.1f}  "
                  f"{k['name']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
