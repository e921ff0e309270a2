"""Where one full-width /generate micro-batch spends its time, on the GPU.

    python scripts/torch_profile_generate.py

Drives the PyTorch port's ``RationaleGenerator`` as ``cli.serve --generate``
builds it at full width (``EncoderConfig()`` in bf16, ``GPT2Config()`` in
fp32, random weights from a seed) at 4 questions a forward and 32 greedy
decode steps, and reports, per micro-batch:

- the classify forward and the decode (prefill + 32 steps), each between
  CUDA events, and the decode's host wall time up to a synchronize;
- ``torch.profiler`` over one decode: device time by kernel, grouped into
  matrix products and the rest, kernel launches per decoder call, and the
  device's busy share of the decode (kernel time over the decode's span
  between CUDA events).

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

REPS, QUESTIONS, STEPS = 5, 4, 32


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_generate: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from multimodal_context_reasoning_torch.core.config import (
        ChunkAlignConfig,
        EncoderConfig,
        GPT2Config,
        ModCRConfig,
    )
    from multimodal_context_reasoning_torch.data.collate import BatchSpec
    from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
    from multimodal_context_reasoning_torch.models.rationale import RationaleModel
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    cfg = ModCRConfig().with_dtype("bfloat16")
    enc, sched, gpt = EncoderConfig(dtype="bfloat16"), ChunkAlignConfig(), GPT2Config()
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len, roberta_len=cfg.roberta_len,
                     img_feature_dim=enc.img_feature_dim)
    images, questions = synthetic_requests(np.random.default_rng(0), QUESTIONS, cfg)
    model = RationaleModel(enc, sched, gpt, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    gen = RationaleGenerator(enc, sched, gpt, model, hash_tokenizers(cfg)[0],
                             HashTokenizer(vocab_size=gpt.vocab_size), images, spec=spec,
                             micro_batch=QUESTIONS, max_rationale_len=STEPS, device="cuda")
    batch = gen.device_batch([gen.featurize(q) for q in questions])
    classify, decode, decode_wall = [], [], []
    with torch.inference_mode():
        for _ in range(REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            out = gen.model(batch)
            ev[1].record()
            t0 = time.perf_counter()
            gen.decode(out)
            ev[2].record()
            ev[2].synchronize()
            decode_wall.append(1e3 * (time.perf_counter() - t0))
            classify.append(ev[0].elapsed_time(ev[1]))
            decode.append(ev[1].elapsed_time(ev[2]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            gen.decode(out)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    matmul = ("gemm", "nvjet", "cutlass", "xmma", "cublas", "matmul")
    groups = {"matmul": 0.0, "other": 0.0}
    for e in kernels:
        groups["matmul" if any(m in e.key.lower() for m in matmul) else "other"] += (
            device_us(e) / 1e3)
    calls = STEPS + 1
    launches = sum(e.count for e in kernels)
    row = dict(
        questions=QUESTIONS, steps=STEPS,
        classify_ms=statistics.median(classify), decode_ms=statistics.median(decode),
        decode_wall_ms=statistics.median(decode_wall),
        decode_device_ms_by_group=groups,
        decode_busy_share=sum(groups.values()) / statistics.median(decode),
        kernel_launches_per_decoder_call=launches / calls,
        top_kernels=[dict(name=e.key[:90], ms_per_decode=device_us(e) / 1e3,
                          calls_per_decoder_call=e.count / calls)
                     for e in sorted(kernels, key=device_us, reverse=True)[:8]],
    )
    print(f"[generate] {QUESTIONS} questions, {STEPS} steps: classify {row['classify_ms']:.2f} "
          f"ms, decode {row['decode_ms']:.2f} ms on the device clock ({row['decode_wall_ms']:.2f} "
          f"ms host wall) | decode kernels: matmul {groups['matmul']:.2f} ms, other "
          f"{groups['other']:.2f} ms, busy {row['decode_busy_share']:.1%} of the decode | "
          f"{row['kernel_launches_per_decoder_call']:.0f} launches per decoder call")
    print(json.dumps({"card": card, "generate": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
