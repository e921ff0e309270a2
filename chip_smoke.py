"""GPU smoke run of the PyTorch port: build, check and time its three CUDA
kernels, serve full-width PMR scoring, train the PMR step at full width,
run the two commands (``cli/run_pmr.py``, ``cli/run_vcr.py``) at full width,
hold every kernel route to its plain version past 192 keys, and serve
concurrent HTTP clients through the serve command (``cli/serve.py``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero (printing no result) without one, when
the port is not beside this script, or when any phase fails.  Phases:

1. device: card name, power limit, TF32 off;
2. build: ``nvcc`` builds ``csrc/{spec_attention,fused_attention,flash_bwd}.cu``
   (the first two share ``csrc/attention_mma.cuh``) from this checkout, one
   process per source, all started together, and prints each kernel's
   registers and spill bytes as ``ptxas -v`` gives them (the bf16 forwards
   once per instance: keys / 16 and mask functor);
3. kernel vs plain: the stage-mask kernel against its plain PyTorch version
   at the five ModCR shapes of each served micro-batch (8 and 32), fp32
   (1e-4 abs, the FP32-pipe route) and bf16 (2e-2 abs, the tensor-core
   route), plus fully masked rows, and two bf16 launches bit-equal;
4. timing: kernel, plain version and ``F.scaled_dot_product_attention`` with
   the same mask as a dense boolean (the yardstick only; the port never
   calls it), bf16 at the micro-batch-8 shapes, CUDA events, median of 25
   calls each in its own window; then the kernel and SDPA as 25 launches
   back to back in one window, divided by 25 (median of 5 windows); each
   summed over one forward's 60 launches; 4b: the kernel, plain version
   and SDPA per call and back to back at the frozen encoders' shapes of a
   32-example training step, (128, 190, 190, 12, 64) in the full and chunk
   stages and (32, 51, 51, 12, 64);
5. end-to-end parity: full-width fp32 ``ModCRConfig()`` scoring one example
   on the card (kernel) and on the CPU (plain version), same weights;
6. serving: full-width bf16 ``ModCRScorer`` at micro-batch 8 and 32; every
   forward must launch the stage-mask kernel exactly 60 times;
7. training kernels vs plain, at the RoBERTa training shape (128 rows,
   Lq 128, Lk 138, 16 heads, Dh 64), fp32 and bf16, ragged padding: the
   dense-bias forward (tolerances as phase 3; bf16 on the tensor-core
   kernel, also at Lq = Lk = 190 with the chunk stage's [B, 1, Lq, Lk] mask
   plane as bias, 2e-2 of max |plain|); the backward's dq, dk, dv and
   dbias plane with a random dO (1e-4 of each output's max |plain| in fp32:
   atomics and summation order; 2e-2 in bf16: P and dS are rounded before
   their products); the stage-mask Function's gradients against autograd of
   its plain version in the full stage at that shape and in the chunk stage
   at (32, 190, 190, 12, 64); a fully masked row; the bf16 backward at
   Lq = Lk = 190 with the chunk stage's [B, 1, Lq, Lk] mask plane as bias,
   and two bf16 launches at the training shape bit-equal in dq, dk, dv;
8. training kernel timing, bf16 at that shape: kernel, plain version and
   SDPA with the float bias as ``attn_mask`` (forward) or SDPA's backward
   through autograd (backward), CUDA events, median of 25 calls each in its
   own event window (the wrapper's host time included), and each kernel's
   share of its bound; then the kernel and SDPA again as 25 launches back
   to back in one window, divided by 25 (the median of 5 such windows);
9. training parity: full-width fp32 ``ModCRConfig()`` with dropout 0, one
   example (4 rows), two ``train_step``s on the card (kernels) and on the CPU
   (plain versions) from one state dict, ``remat=False`` (the stage-mask
   forward and the backward kernel): losses and gradient norms to 1e-4
   relative;
10. training (the slice's main path): the production geometry in bf16 with
    dropout 0, RoBERTa remat "full", 32 examples (128 rows) per step, 8 steps
    through ``Trainer.fit`` with validation every 4 steps and a best-accuracy
    checkpoint in a temporary directory; every train step launches exactly
    36 stage-mask, 48 dense-forward and 24 backward kernels;
11. the ``kernels`` JSON line (each kernel's ``launches`` from phase 10's
    run, ``cli_launches`` from phase 12's, ``serve_launches`` from phase
    14's, and ``long_keys`` from phase 13), then the result line;
12. (run before 11) the two commands through ``main(argv)``, full-width
    bf16, on files written from the seed in a temporary directory (PMR
    JSONL of 64 / 32 / 32 examples, a VCR JSON of 64, 50 x 2054 region
    features per image as a pickle and an ``.mcrpack``): ``run_pmr
    --do_train`` at the reference defaults otherwise (16 examples a step, 4
    steps, validation every 2; dropout 0.1 in RoBERTa, so a train step
    launches no kernel), checking finite losses, ``config.json`` and a best
    checkpoint; ``run_pmr --do_test`` from that checkpoint on the
    ``.mcrpack``, checking one prediction per example; ``run_vcr --do_train``
    for 2 steps of 4 micro-batches, checking that the RoBERTa body is
    bit-unchanged and its embeddings and the mapping networks trained; and
    ``run_pmr --do_test --max_img_seq_length 100`` (random init, 100 regions
    an image: 240 encoder keys, the bf16 kernels' key-looped instances),
    checking one prediction per example.  Every validation and test forward
    must launch the stage-mask kernel exactly
    ``spec_launches_per_eval_forward`` (57) times;
13. (run before 11) long keys: the stage-mask forward (full, chunk, cross),
    the dense forward (row and plane bias) and the backward with dbias, fp32
    and bf16, against their plain versions at Lk 240 and 520 (32 rows, 12
    heads; tolerances as phases 3 and 7), fully masked rows, and two bf16
    launches bit-equal at 240; then bf16 kernel, plain version, SDPA and
    bound per call and back to back at (128, 240, 240, 12, 64) full and
    chunk stage and at (128, 230, 240, 16, 64) for the dense forward and
    the backward;
14. (run before 11) serving, the slice's main path: ``python -m
    multimodal_context_reasoning_torch.cli.serve`` as a subprocess on a free
    port (full width, bf16, micro-batch 8, seeded random init, an
    ``.mcrpack``), polled on ``/healthz``; 16 concurrent clients send 4
    requests each of 1-4 examples (after a warm-up round of 16 one-example
    requests); every reply must be 200 with finite logits within 2e-2 of
    max |logit| of direct ``ModCRScorer.score`` on the same weights, and the
    same prediction wherever the direct top two logits are more than twice
    that apart; examples/s, p50/p99 request latency and the mean dispatch
    size (``/stats``) are printed; the server must exit on SIGTERM.  The same
    load then runs in-process through ``serve(block=False)`` on the direct
    scorer with the kernel counts set to 0 before and read after: 57
    stage-mask launches per dispatched forward.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # of each output's max |plain|
LAUNCHES_PER_FORWARD = 60
MICRO_BATCHES = (8, 32)
SEED = 0
KERNELS = ("spec_attention", "fused_attention", "flash_bwd")
# per train step of the slice: frozen encoders 12 + 12 + 12 stage-mask
# launches; RoBERTa 24 dense forwards, 24 remat recomputes and 24 backwards
STEP_LAUNCHES = {"spec_attention": 36, "fused_attention": 48, "flash_bwd": 24}
TRAIN_SHAPE = dict(B=128, lq=128, prefix=10, H=16, dh=64)
TRAIN_EXAMPLES, TRAIN_STEPS, VALID_STEPS = 32, 8, 4
# phase 12: examples per file, the train batch (the CLI's default eval batch
# is 16 as well)
CLI_SIZES = {"train": 64, "val": 32, "test": 32, "vcr": 64}
CLI_BATCH = CLI_EVAL_BATCH = 16
LONG_IMG_LEN = 100          # phase 12's last run: 140 + 100 = 240 encoder keys
LONG_KEYS = (240, 520)      # phase 13: past the bf16 kernels' resident 192 keys
# phase 14: concurrent clients, requests per client, examples per request
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_EXAMPLES = 16, 4, (1, 4)
SERVE_MICRO_BATCH = 8
ROOT = os.path.dirname(os.path.abspath(__file__))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs

def chunk_ids(rng, length: int) -> np.ndarray:
    """Chunk ids over positions 1..length-2 the way the featurizer lays
    them out: runs of 1-4 tokens, some positions outside any chunk."""
    gi = np.full(length, -1, np.int32)
    t, cid = 1, 0
    while t < length - 1:
        run = int(rng.integers(1, 5))
        if rng.random() < 0.2:
            t += run
            continue
        gi[t:min(t + run, length - 1)] = cid
        cid += 1
        t += run
    return gi


def attention_case(rng, name, B, T, I, H, stage, lq=None, prefix=0, dh=64):
    """q, k, v and the stage's mask vectors at one ModCR shape."""
    from multimodal_context_reasoning_torch.ops.masks import stage_mask_specs

    if stage == "roberta":  # full stage over [prefix ‖ tokens]
        lens = rng.integers(20, lq + 1, B)
        valid = np.zeros((B, prefix + lq), np.float32)
        valid[:, :prefix] = 1.0
        for b, n in enumerate(lens):
            valid[b, prefix:prefix + n] = 1.0
        lk = prefix + lq
        vecs = (torch.from_numpy(valid), torch.full((B, lk), -1, dtype=torch.int32),
                torch.zeros(B, lk))
        stage, text_len = "full", lq
    else:
        text_mask = np.zeros((B, T), np.float32)
        gather = np.full((B, T), -1, np.int32)
        for b, n in enumerate(rng.integers(min(T, max(2, T // 4)), T + 1, B)):
            text_mask[b, :n] = 1.0
            gather[b, :n] = chunk_ids(rng, int(n))
        img_mask = np.zeros((B, I), np.float32)
        for b, n in enumerate(rng.integers(10, I + 1, B)):
            img_mask[b, :n] = 1.0
        spec = stage_mask_specs(torch.from_numpy(text_mask), torch.from_numpy(img_mask),
                                torch.from_numpy(gather))[("chunk", "full", "cross").index(stage)]
        vecs = (spec.valid, spec.gi, spec.rowfull)
        lq = lk = T + I
        text_len = T
    q = torch.from_numpy(rng.standard_normal((B, lq, H, dh), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, lk, H, dh), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, lk, H, dh), dtype=np.float32))
    return dict(name=name, q=q, k=k, v=v, vecs=vecs, stage=stage, text_len=text_len)


def shapes(rng, mb: int):
    """(case, launches per forward) for the five ModCR shapes of a
    micro-batch of ``mb`` examples: ``4 * mb`` candidate rows, and ``mb``
    rows on the deduplicated vision pass."""
    n = 4 * mb
    return [
        (attention_case(rng, f"mb{mb} vision full L=51", mb, 1, 50, 12, "full"), 12),
        (attention_case(rng, f"mb{mb} encoder chunk L=190", n, 140, 50, 12, "chunk"), 3),
        (attention_case(rng, f"mb{mb} encoder full L=190", n, 140, 50, 12, "full"), 18),
        (attention_case(rng, f"mb{mb} encoder cross L=190", n, 140, 50, 12, "cross"), 3),
        (attention_case(rng, f"mb{mb} roberta full Lq=128 Lk=138", n, 0, 0, 16,
                        "roberta", lq=128, prefix=10), 24),
    ]


def cuda_args(case, dtype):
    q, k, v = (case[n].to("cuda", dtype) for n in ("q", "k", "v"))
    valid, gi, rowfull = (t.cuda().contiguous() for t in case["vecs"])
    return q, k, v, valid, gi, rowfull


# ---------------------------------------------------------------- timing

def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, n: int = 25, windows: int = 5, warmup: int = 3) -> float:
    """Median over ``windows`` event windows of ``n`` calls back to back, per
    call: the host's launch work overlaps the device's, unlike ``median_ms``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(case, dtype):
    """Least time for the work: bytes (q, k, v and the mask vectors read
    once, out written once) over HBM rate vs FLOPs over the dtype's peak."""
    q, k = case["q"], case["k"]
    B, lq, H, dh = q.shape
    lk = k.shape[1]
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * (2 * B * lq * H * dh + 2 * B * lk * H * dh) + 12 * B * lk
    flops = 4.0 * B * H * lq * lk * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(q, k, v, valid, gi, rowfull, case):
    from multimodal_context_reasoning_torch.ops.spec_attention import stage_visibility

    mask = stage_visibility(valid, gi, rowfull, stage=case["stage"],
                            text_len=case["text_len"], lq=q.shape[1]) > 0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = mask[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)


# ---------------------------------------------------------------- training

def wrappers():
    """Each kernel's wrapper, by kernel name: their ``launches`` counters."""
    from multimodal_context_reasoning_torch.ops.flash import flash_attention_bwd
    from multimodal_context_reasoning_torch.ops.fused_attention import fused_attention
    from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec

    return {"spec_attention": fused_attention_spec, "fused_attention": fused_attention,
            "flash_bwd": flash_attention_bwd}


def reset_counts() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in wrappers().items()}


def dense_case(rng, B, lq, prefix, H, dh):
    """q, k, v, a random dO and the validity of RoBERTa's prefixed KV stream
    (the prefix slots always valid, 20 to Lq real tokens) at a training shape."""
    lk = prefix + lq
    valid = np.zeros((B, lk), np.float32)
    valid[:, :prefix] = 1.0
    for b, n in enumerate(rng.integers(20, lq + 1, B)):
        valid[b, prefix:prefix + n] = 1.0
    normal = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return dict(q=normal(B, lq, H, dh), k=normal(B, lk, H, dh), v=normal(B, lk, H, dh),
                d_out=normal(B, lq, H, dh), valid=torch.from_numpy(valid))


def errors(got, want):
    """(max |got - want|, that over max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def spec_grad_errors(q, k, v, vecs, d_out, **kw):
    """The stage-mask Function's q, k, v gradients (kernel forward, backward
    kernel) against autograd of its plain version: worst (abs, rel)."""
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
    )

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fused_attention_spec(*leaves, *vecs, **kw).backward(d_out)
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    spec_attention_plain(*ref, *vecs, **kw).backward(d_out)
    torch.cuda.synchronize()
    errs = [errors(a.grad, b.grad) for a, b in zip(leaves, ref)]
    check(all(torch.isfinite(a.grad).all().item() for a in leaves), "non-finite spec grads")
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_training_kernels(rng) -> dict:
    """Phase 7; returns the worst absolute error of each kernel."""
    from multimodal_context_reasoning_torch.ops.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )
    from multimodal_context_reasoning_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_plain,
    )
    from multimodal_context_reasoning_torch.ops.masks import full_mask_spec, padding_bias
    from multimodal_context_reasoning_torch.ops.spec_attention import spec_bias

    worst = {"fused_attention": 0.0, "flash_bwd": 0.0, "spec_attention": 0.0}
    case = dense_case(rng, **TRAIN_SHAPE)
    masked = dense_case(rng, 4, 30, 10, 4, 64)
    masked["valid"][1] = 0.0                  # a batch row with no visible key
    chunk = attention_case(rng, "chunk L=190", 32, 140, 50, 12, "chunk")
    for name, c in (("roberta (128, 128, 138, 16, 64)", case),
                    ("fully masked row", masked)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, d_out = (c[n].to("cuda", dtype) for n in ("q", "k", "v", "d_out"))
            valid = c["valid"].cuda()
            bias = padding_bias(valid)
            got = fused_attention(q, k, v, bias)
            torch.cuda.synchronize()
            f_err, _ = errors(got, fused_attention_plain(q, k, v, bias))
            check(torch.isfinite(got).all().item() and f_err <= TOL[dtype],
                  f"dense forward {name} {dtype}: {f_err}")
            worst["fused_attention"] = max(worst["fused_attention"], f_err)
            got = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=True)
            torch.cuda.synchronize()
            want = flash_attention_bwd_plain(q, k, v, bias, d_out)
            line = []
            for out, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
                err, rel = errors(g, w)
                check(torch.isfinite(g).all().item() and rel <= BWD_TOL[dtype],
                      f"backward {out} {name} {dtype}: rel {rel}")
                worst["flash_bwd"] = max(worst["flash_bwd"], err)
                line.append(f"{out} {err:.2e} ({rel:.1e} rel)")
            spec = full_mask_spec(valid, q.shape[1])
            s_err, s_rel = spec_grad_errors(q, k, v, (spec.valid, spec.gi, spec.rowfull),
                                            d_out, stage="full", text_len=q.shape[1])
            check(s_rel <= BWD_TOL[dtype], f"spec grads full {name} {dtype}: rel {s_rel}")
            worst["spec_attention"] = max(worst["spec_attention"], s_err)
            print(f"[7 train check] {name:32s} {str(dtype):15s} forward {f_err:.2e} | "
                  "backward " + " | ".join(line)
                  + f" | spec-Function grads {s_err:.2e} ({s_rel:.1e} rel)")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, *vecs = cuda_args(chunk, dtype)
        d_out = torch.randn(q.shape, device="cuda", dtype=dtype,
                            generator=torch.Generator("cuda").manual_seed(SEED))
        s_err, s_rel = spec_grad_errors(q, k, v, vecs, d_out, stage="chunk",
                                        text_len=chunk["text_len"])
        check(s_rel <= BWD_TOL[dtype], f"spec grads chunk {dtype}: rel {s_rel}")
        worst["spec_attention"] = max(worst["spec_attention"], s_err)
        print(f"[7 train check] {'chunk (32, 190, 190, 12, 64)':32s} {str(dtype):15s} "
              f"spec-Function grads {s_err:.2e} ({s_rel:.1e} rel)")
    # bf16 at the chunk stage's length, the longest keys the tensor-core
    # kernels take on the model's path, with the stage's [B, 1, Lq, Lk] mask
    # plane: the forward, then the backward
    q, k, v, *vecs = cuda_args(chunk, torch.bfloat16)
    bias = spec_bias(*vecs, stage="chunk", text_len=chunk["text_len"], lq=q.shape[1])
    got = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    f_err, f_rel = errors(got, fused_attention_plain(q, k, v, bias))
    check(torch.isfinite(got).all().item() and f_rel <= TOL[torch.bfloat16],
          f"dense forward L=190 plane bf16: rel {f_rel}")
    worst["fused_attention"] = max(worst["fused_attention"], f_err)
    print(f"[7 train check] {'chunk plane (32, 190, 190, 12, 64)':32s} {'torch.bfloat16':15s} "
          f"forward {f_err:.2e} ({f_rel:.1e} rel)")
    d_out = torch.randn(q.shape, device="cuda", dtype=torch.bfloat16,
                        generator=torch.Generator("cuda").manual_seed(SEED + 3))
    got = flash_attention_bwd(q, k, v, bias, d_out, want_dbias=True)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, bias, d_out)
    line = []
    for out, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        err, rel = errors(g, w)
        check(torch.isfinite(g).all().item() and rel <= BWD_TOL[torch.bfloat16],
              f"backward {out} L=190 bf16: rel {rel}")
        worst["flash_bwd"] = max(worst["flash_bwd"], err)
        line.append(f"{out} {err:.2e} ({rel:.1e} rel)")
    print(f"[7 train check] {'chunk plane (32, 190, 190, 12, 64)':32s} {'torch.bfloat16':15s} "
          "backward " + " | ".join(line))
    del got, want
    q, k, v, d_out = (case[n].to("cuda", torch.bfloat16) for n in ("q", "k", "v", "d_out"))
    bias = padding_bias(case["valid"].cuda())
    runs = [flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False)[:3] for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"[7 train check] bf16 backward, two launches at (128, 128, 138, 16, 64): "
          f"dq, dk, dv bit-equal {same}")
    check(same, "bf16 backward: two launches differ")
    print(f"[7 train check] worst |kernel - plain|: {worst} (forward tol {TOL}, "
          f"backward tol of max |plain| {BWD_TOL})")
    return worst


def train_bound(case, dtype, kind: str):
    """Least time: bytes (each input read once, each output written once)
    over HBM rate vs FLOPs over the dtype's peak.  Forward: q, k, v, bias
    in, out out; 2 products.  Backward: q, k, v, dO, bias in, dq, dk, dv out
    (no dbias plane, as the model calls it); 5 products."""
    B, lq, H, dh = case["q"].shape
    lk = case["k"].shape[1]
    elt = torch.finfo(dtype).bits // 8
    qn, kn = B * lq * H * dh, B * lk * H * dh
    if kind == "forward":
        nbytes, flops = elt * (2 * qn + 2 * kn) + 4 * B * lk, 4.0 * B * H * lq * lk * dh
    else:
        nbytes, flops = elt * (3 * qn + 4 * kn) + 4 * B * lk, 10.0 * B * H * lq * lk * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_training_kernels(rng) -> dict:
    """Phase 8: bf16 at the training shape; returns the kernels-line numbers."""
    from multimodal_context_reasoning_torch.ops.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )
    from multimodal_context_reasoning_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_plain,
    )
    from multimodal_context_reasoning_torch.ops.masks import padding_bias

    dt = torch.bfloat16
    case = dense_case(rng, **TRAIN_SHAPE)
    q, k, v, d_out = (case[n].to("cuda", dt) for n in ("q", "k", "v", "d_out"))
    bias = padding_bias(case["valid"].cuda())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = bias.to(dt)
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    qt, kt, vt = (t.detach().requires_grad_() for t in (q4, k4, v4))
    out_t = sdpa(qt, kt, vt, attn_mask=mask)
    d_out_t = d_out.transpose(1, 2)
    rows = {}
    for name, kind, kernel, plain, library in (
        ("fused_attention", "forward", lambda: fused_attention(q, k, v, bias),
         lambda: fused_attention_plain(q, k, v, bias),
         lambda: sdpa(q4, k4, v4, attn_mask=mask)),
        ("flash_bwd", "backward",
         lambda: flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False),
         lambda: flash_attention_bwd_plain(q, k, v, bias, d_out),
         lambda: torch.autograd.grad(out_t, (qt, kt, vt), d_out_t, retain_graph=True)),
    ):
        ms, plain_ms, lib_ms = median_ms(kernel), median_ms(plain), median_ms(library)
        b2b_ms, lib_b2b_ms = back_to_back_ms(kernel), back_to_back_ms(library)
        b_ms, b_by = train_bound(case, dt, kind)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by, back_to_back_ms=b2b_ms,
                          library_back_to_back_ms=lib_b2b_ms)
        print(f"[8 train time] {name:16s} bf16 (128, 128, 138, 16, 64): kernel {ms:.4f} ms | "
              f"plain {plain_ms:.4f} ms | sdpa {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) "
              f"| kernel at {b_ms / ms:.2%} of its bound")
        print(f"[8 train time] {name:16s} 25 back to back, per launch: kernel {b2b_ms:.4f} ms "
              f"({b_ms / b2b_ms:.2%} of its bound) | sdpa {lib_b2b_ms:.4f} ms | "
              f"kernel / sdpa {b2b_ms / lib_b2b_ms:.2f}")
    dbias_ms = median_ms(lambda: flash_attention_bwd(q, k, v, bias, d_out, want_dbias=True))
    print(f"[8 train time] flash_bwd with the dbias plane (not on the model's path): "
          f"{dbias_ms:.4f} ms")
    return rows


def training_parity(rng) -> dict:
    """Phase 9: two fp32 train steps, card against CPU, remat off."""
    from multimodal_context_reasoning_torch.core.config import TrainConfig, pmr_training_config
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
    from multimodal_context_reasoning_torch.train.state import TrainState
    from multimodal_context_reasoning_torch.train.step import train_step

    cfg = pmr_training_config(dtype="float32", remat=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    model = ModCRModel(cfg, device="cuda", generator=gen)
    cpu_model = ModCRModel(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = synthetic_dataset(rng, 1, cfg).batch([0])
    runs = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        state = TrainState.create(m, TrainConfig(), total_steps=10)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        reset_counts()
        t0 = time.perf_counter()
        metrics = [train_step(state, tb) for _ in range(2)]
        runs[dev] = dict(loss=[float(x["loss"]) for x in metrics],
                         grad_norm=[float(x["grad_norm"]) for x in metrics],
                         seconds=time.perf_counter() - t0, launches=read_counts())
        del state
    rel = max(abs(a - b) / abs(b) for key in ("loss", "grad_norm")
              for a, b in zip(runs["cuda"][key], runs["cpu"][key]))
    print(f"[9 train parity] full-width fp32, 1 example (4 rows), 2 steps, remat off: "
          f"cuda loss {runs['cuda']['loss']} grad_norm {runs['cuda']['grad_norm']} | "
          f"cpu loss {runs['cpu']['loss']} grad_norm {runs['cpu']['grad_norm']} | "
          f"max rel diff {rel:.3e} (tol 1e-4) | card launches {runs['cuda']['launches']} | "
          f"cpu {runs['cpu']['seconds']:.1f} s")
    check(all(np.isfinite(runs["cuda"][k]).all() for k in ("loss", "grad_norm")),
          "non-finite fp32 training metrics")
    check(rel <= 1e-4, f"training parity: rel diff {rel}")
    check(runs["cuda"]["launches"]["flash_bwd"] == 2 * 24
          and runs["cuda"]["launches"]["spec_attention"] == 2 * 60,
          f"fp32 remat-off launches {runs['cuda']['launches']}")
    return dict(max_rel_diff=rel, cuda=runs["cuda"], cpu=runs["cpu"])


def counted(fn, log):
    """``fn`` that appends its seconds (synchronized), result and kernel
    launches to ``log`` on each call."""
    def run(*args):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        after = read_counts()
        log.append(dict(seconds=time.perf_counter() - t0, out=out,
                        launches={k: after[k] - before[k] for k in after}))
        return out
    return run


def train_slice(rng) -> dict:
    """Phase 10, the slice's main path: Trainer.fit at full width."""
    from multimodal_context_reasoning_torch.core.config import TrainConfig, pmr_training_config
    from multimodal_context_reasoning_torch.data.loader import DataLoader
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.synthetic import synthetic_dataset
    from multimodal_context_reasoning_torch.train.trainer import Trainer

    cfg = pmr_training_config()
    model = ModCRModel(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    train_ds = synthetic_dataset(rng, TRAIN_EXAMPLES * TRAIN_STEPS, cfg, first=10_000)
    val_ds = synthetic_dataset(rng, 2 * TRAIN_EXAMPLES, cfg, first=20_000)
    tcfg = TrainConfig(per_device_batch_size=TRAIN_EXAMPLES, max_steps=TRAIN_STEPS,
                       valid_steps=VALID_STEPS, epoch_begin=1, seed=SEED)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if "_enc." in n}
    ckpt_dir = tempfile.mkdtemp(prefix="modcr_ckpt_")
    trainer = Trainer(model, tcfg, DataLoader(train_ds, TRAIN_EXAMPLES, shuffle=True, seed=SEED),
                      DataLoader(val_ds, TRAIN_EXAMPLES), checkpoint_dir=ckpt_dir,
                      checkpoint_params_only=True)
    trainer.best_acc = -1.0   # the first validation saves a checkpoint
    steps, evals, saves = [], [], []

    trainer.train_step = counted(trainer.train_step, steps)
    trainer.eval_step = counted(trainer.eval_step, evals)
    trainer.ckpt.save = counted(trainer.ckpt.save, saves)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    saved = trainer.ckpt.all_steps()
    shutil.rmtree(ckpt_dir)

    losses = [float(s["out"]["loss"]) for s in steps]
    check(len(steps) == TRAIN_STEPS and state.step == TRAIN_STEPS,
          f"{len(steps)} train steps, state at {state.step}")
    check(np.isfinite(losses).all(), f"non-finite losses {losses}")
    for i, s in enumerate(steps):
        check(s["launches"] == STEP_LAUNCHES, f"step {i}: launches {s['launches']}")
    check(all(p.dtype == torch.float32 for p in model.parameters()), "parameters left fp32")
    check(all(torch.equal(p, frozen[n]) for n, p in model.named_parameters() if n in frozen),
          "a frozen encoder weight changed")
    check(bool(saved) and len(trainer.history) == TRAIN_STEPS // VALID_STEPS,
          f"checkpoints {saved}, validations {trainer.history}")
    check(all(launches[k] > 0 for k in KERNELS), f"main-path launches {launches}")
    step_ms = [1e3 * s["seconds"] for s in steps]
    steady = statistics.median(step_ms[1:])
    val_launches = {k: sum(e["launches"][k] for e in evals) for k in KERNELS}
    print(f"[10 train] bf16 production geometry, remat full, dropout 0, "
          f"{TRAIN_EXAMPLES} examples ({4 * TRAIN_EXAMPLES} rows) per step: losses "
          f"{np.round(losses, 4).tolist()}")
    print(f"[10 train] ms per step {np.round(step_ms, 2).tolist()} -> steady (median of "
          f"steps 2-{TRAIN_STEPS}) {steady:.2f} ms = {TRAIN_EXAMPLES / steady * 1e3:.2f} "
          f"examples/s | fit wall {wall:.2f} s (validation, checkpoint and data included) "
          f"| peak {peak:.2f} GiB")
    print(f"[10 train] launches per train step {steps[0]['launches']} (all {TRAIN_STEPS} "
          f"equal), {len(evals)} validation forwards launched {val_launches} | validation "
          f"{[round(h['val_acc'], 4) for h in trainer.history]} | checkpoints "
          f"{[round(s['seconds'], 2) for s in saves]} s, kept steps {saved} | all of fit "
          f"{launches}")
    return dict(launches=launches, steady_ms_per_step=steady,
                examples_per_s=TRAIN_EXAMPLES / steady * 1e3, peak_gib=peak,
                ms_per_step=step_ms, losses=losses, fit_seconds=wall,
                validation_launches=val_launches,
                checkpoint_seconds=[s["seconds"] for s in saves])


def time_training_spec_shapes(rng) -> list:
    """Phase 4b: the stage-mask kernel at the frozen encoders' shapes of a
    32-example training step, bf16: kernel, plain version and SDPA, per call
    and back to back."""
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
    )

    rows = []
    for case in (
        attention_case(rng, "train encoder full (128, 190, 190, 12, 64)", 128, 140, 50, 12,
                       "full"),
        attention_case(rng, "train encoder chunk (128, 190, 190, 12, 64)", 128, 140, 50, 12,
                       "chunk"),
        attention_case(rng, "train vision full (32, 51, 51, 12, 64)", 32, 1, 50, 12, "full"),
    ):
        args = cuda_args(case, torch.bfloat16)
        kw = dict(stage=case["stage"], text_len=case["text_len"])
        kernel = lambda: fused_attention_spec(*args, **kw)
        plain = lambda: spec_attention_plain(*args, **kw)
        sdpa = sdpa_call(*args, case)
        b_ms, b_by = bound(case, torch.bfloat16)
        row = dict(shape=case["name"], ms=median_ms(kernel), plain_ms=median_ms(plain),
                   library_ms=median_ms(sdpa), b2b_ms=back_to_back_ms(kernel),
                   plain_b2b_ms=back_to_back_ms(plain), library_b2b_ms=back_to_back_ms(sdpa),
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print(f"[4b train shapes] {case['name']:44s} per call: kernel {row['ms']:.4f} | plain "
              f"{row['plain_ms']:.4f} | sdpa {row['library_ms']:.4f} ms; back to back: kernel "
              f"{row['b2b_ms']:.4f} | plain {row['plain_b2b_ms']:.4f} | sdpa "
              f"{row['library_b2b_ms']:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
        del args
    return rows


def spec_launches_per_eval_forward(cfg) -> int:
    """Stage-mask launches of one deterministic forward: the global encoder
    twice (the vision pass and the text-image pass), the ChunkAlign encoder
    without its cross-stage layers when they return the alignment
    probabilities, and every RoBERTa layer.  Full width with the alignment
    loss on: 12 + 12 + (12 - 3) + 24 = 57."""
    cross = cfg.seq_encoder.num_hidden_layers - cfg.chunkalign.full_layers_end
    return (2 * cfg.global_encoder.num_hidden_layers + cfg.seq_encoder.num_hidden_layers
            - (cross if cfg.compute_alignment else 0) + cfg.roberta.num_hidden_layers)


def cli_phase(rng) -> dict:
    """Phase 12: ``run_pmr --do_train``, ``run_pmr --do_test`` from its
    checkpoint and ``run_vcr --do_train`` through ``main(argv)``, full
    width, bf16, at the reference defaults otherwise (dropout 0.1 in
    RoBERTa, the encoders' ``--drop_out``, the alignment loss on), on data
    written from the seed; then the bf16 key-limit refusal."""
    from multimodal_context_reasoning_torch.cli import run_pmr, run_vcr
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.data.feature_store import write_pack
    from multimodal_context_reasoning_torch.serving.synthetic import (
        region_features,
        task_rows,
        write_rows,
    )
    from multimodal_context_reasoning_torch.train import trainer as trainer_mod

    cfg = ModCRConfig()
    tmp = tempfile.mkdtemp(prefix="modcr_cli_")
    path = lambda name: f"{tmp}/{name}"
    rows = {"train": task_rows(rng, CLI_SIZES["train"], cfg.img_len, first=0),
            "val": task_rows(rng, CLI_SIZES["val"], cfg.img_len, first=10_000),
            "test": task_rows(rng, CLI_SIZES["test"], cfg.img_len, first=20_000),
            "vcr": task_rows(rng, CLI_SIZES["vcr"], cfg.img_len, vcr=True, first=30_000)}
    for name, r in rows.items():
        write_rows(path(f"{name}.jsonl"), r)
    feats = region_features(rng, sum(rows.values(), []), cfg.img_len,
                            cfg.global_encoder.img_feature_dim)
    with open(path("feats.pkl"), "wb") as f:
        pickle.dump({k: {"features": v} for k, v in feats.items()}, f)
    write_pack(feats, path("feats.mcrpack"))
    common = ["--per_gpu_train_batch_size", str(CLI_BATCH), "--compute_dtype", "bfloat16",
              "--seed", str(SEED)]
    per_forward = spec_launches_per_eval_forward(cfg)
    steps, evals, snapshots = [], [], []
    train_step, eval_step = trainer_mod.train_step, trainer_mod.eval_step
    fit = trainer_mod.Trainer.fit

    def snapshot_fit(self, state=None):
        if self.freeze_roberta_body:   # run_vcr: what its checks compare
            snapshots.append({n: p.detach().clone() for n, p in self.model.named_parameters()
                              if n.startswith(("roberta.", "mapping_network_"))})
        return fit(self, state)

    trainer_mod.train_step = counted(train_step, steps)
    trainer_mod.eval_step = counted(eval_step, evals)
    run_pmr.eval_step = counted(eval_step, evals)
    trainer_mod.Trainer.fit = snapshot_fit
    out: dict = {}
    try:
        reset_counts()
        # 1. PMR training at the reference defaults
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_pmr.main(["--do_train", "--train_file", path("train.jsonl"),
                      "--val_file", path("val.jsonl"), "--img_feat_file", path("feats.pkl"),
                      "--output_dir", path("pmr"), "--max_steps", "4", "--valid_steps", "2",
                      "--epoch_begin", "0", *common])
        train_wall = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(s["out"]["loss"]) for s in steps]
        step_ms = [1e3 * s["seconds"] for s in steps]
        check(len(steps) == 4 and np.isfinite(losses).all(), f"PMR train losses {losses}")
        check(all(all(v == 0 for v in s["launches"].values()) for s in steps),
              f"train steps under dropout launched {[s['launches'] for s in steps]}")
        ckpts = [d for d in os.listdir(path("pmr/ckpt")) if d.isdigit()]
        check(bool(ckpts) and os.path.exists(path("pmr/config.json")),
              f"checkpoints {ckpts}, config.json written")
        val_counts = [e["launches"]["spec_attention"] for e in evals]
        check(len(evals) == 2 * CLI_SIZES["val"] // CLI_EVAL_BATCH
              and all(c == per_forward for c in val_counts),
              f"validation forwards launched {val_counts}, {per_forward} each expected")
        steady = statistics.median(step_ms[1:])
        out["pmr_train"] = dict(losses=losses, ms_per_step=step_ms, steady_ms_per_step=steady,
                                examples_per_s=CLI_BATCH / steady * 1e3, peak_gib=train_peak,
                                wall_s=train_wall, validation_launches=val_counts,
                                checkpoints=ckpts)
        print(f"[12 cli] run_pmr --do_train, bf16 full width, {CLI_BATCH} examples a step, "
              f"dropout on, alignment loss on: losses {np.round(losses, 4).tolist()} | ms per "
              f"step {np.round(step_ms, 2).tolist()} -> steady (median of steps 2-4) "
              f"{steady:.2f} ms = {CLI_BATCH / steady * 1e3:.2f} examples/s | peak "
              f"{train_peak:.2f} GiB | main() {train_wall:.2f} s | train-step launches 0 "
              f"(dropout: plain attention) | validation forwards {val_counts} stage-mask "
              f"launches | checkpoints {ckpts}")

        # 2. PMR test from that run's best checkpoint, features from the .mcrpack
        del evals[:]
        t0 = time.perf_counter()
        acc = run_pmr.main(["--do_test", "--test_file", path("test.jsonl"),
                            "--img_feat_file", path("feats.mcrpack"),
                            "--eval_model_dir", path("pmr"), "--output_dir", path("pmr_test"),
                            *common])
        test_wall = time.perf_counter() - t0
        with open(path("pmr_test/result_test_ModICR_pmr.json")) as f:
            preds = [json.loads(line) for line in f]
        test_counts = [e["launches"]["spec_attention"] for e in evals]
        n_forwards = -(-CLI_SIZES["test"] // CLI_EVAL_BATCH)
        check(len(preds) == CLI_SIZES["test"] and all(0 <= p["prediction"] < 4 for p in preds),
              f"{len(preds)} prediction lines")
        check(len(evals) == n_forwards and all(c == per_forward for c in test_counts),
              f"test forwards launched {test_counts}, {per_forward} each expected")
        test_forward_s = sum(e["seconds"] for e in evals)
        out["pmr_test"] = dict(accuracy=acc, forwards=len(evals), spec_launches=test_counts,
                               launches_per_forward=per_forward,
                               examples_per_s=CLI_SIZES["test"] / test_forward_s,
                               wall_s=test_wall)
        print(f"[12 cli] run_pmr --do_test --eval_model_dir (.mcrpack features): "
              f"{len(preds)} prediction lines, accuracy {acc:.4f} | {len(evals)} forwards "
              f"launched {test_counts} stage-mask kernels ({per_forward} each expected) | "
              f"{CLI_SIZES['test'] / test_forward_s:.2f} examples/s over the forwards | "
              f"main() {test_wall:.2f} s")
        shutil.rmtree(path("pmr"))

        # 3. VCR training: the RoBERTa body frozen, 4 accumulated micro-batches
        del steps[:], snapshots[:]
        t0 = time.perf_counter()
        state = run_vcr.main(["--do_train", "--train_file", path("vcr.jsonl"),
                              "--img_feat_file", path("feats.pkl"), "--output_dir", path("vcr"),
                              "--max_steps", "2", *common])
        vcr_wall = time.perf_counter() - t0
        start = snapshots[0]
        params = dict(state.model.named_parameters())
        body = [n for n in params if n.startswith("roberta.encoder.")]
        moved = ("roberta.embeddings.word_embeddings.weight", "mapping_network_vision.1.weight",
                 "mapping_network_alignment.4.weight")
        vcr_losses = [float(s["out"]["loss"]) for s in steps]
        check(len(steps) == 8 and state.step == 8 and np.isfinite(vcr_losses).all(),
              f"VCR micro-steps {len(steps)}, losses {vcr_losses}")
        check(bool(body) and all(torch.equal(params[n], start[n]) for n in body),
              "a frozen RoBERTa body weight changed")
        check(all(not torch.equal(params[n], start[n]) for n in moved),
              "RoBERTa embeddings or a mapping network did not train")
        out["vcr_train"] = dict(losses=vcr_losses, micro_steps=len(steps), wall_s=vcr_wall,
                                body_tensors_unchanged=len(body))
        print(f"[12 cli] run_vcr --do_train: {len(steps)} micro-steps (2 optimizer steps of 4) "
              f"losses {np.round(vcr_losses, 4).tolist()} | {len(body)} RoBERTa body tensors "
              f"bit-unchanged, {', '.join(moved)} changed | main() {vcr_wall:.2f} s")
        del state, params, start, snapshots[:]

        # 4. --do_test at --max_img_seq_length 100: 240 encoder keys, past the
        # 192 the bf16 kernels hold resident (their key-looped instances)
        long_feats = region_features(rng, rows["test"], LONG_IMG_LEN,
                                     cfg.global_encoder.img_feature_dim)
        with open(path("feats_long.pkl"), "wb") as f:
            pickle.dump({k: {"features": v} for k, v in long_feats.items()}, f)
        del evals[:]
        t0 = time.perf_counter()
        long_acc = run_pmr.main(["--do_test", "--max_img_seq_length", str(LONG_IMG_LEN),
                                 "--test_file", path("test.jsonl"),
                                 "--img_feat_file", path("feats_long.pkl"),
                                 "--output_dir", path("pmr_long"), *common])
        long_wall = time.perf_counter() - t0
        with open(path("pmr_long/result_test_ModICR_pmr.json")) as f:
            long_preds = [json.loads(line) for line in f]
        long_counts = [e["launches"]["spec_attention"] for e in evals]
        check(len(long_preds) == CLI_SIZES["test"]
              and all(0 <= p["prediction"] < 4 for p in long_preds),
              f"{len(long_preds)} prediction lines at {LONG_IMG_LEN} regions")
        check(len(evals) == n_forwards and all(c == per_forward for c in long_counts),
              f"240-key test forwards launched {long_counts}, {per_forward} each expected")
        long_forward_s = sum(e["seconds"] for e in evals)
        out["pmr_test_240_keys"] = dict(
            accuracy=long_acc, forwards=len(evals), spec_launches=long_counts,
            examples_per_s=CLI_SIZES["test"] / long_forward_s, wall_s=long_wall)
        print(f"[12 cli] run_pmr --do_test --max_img_seq_length {LONG_IMG_LEN} (140 + "
              f"{LONG_IMG_LEN} = {140 + LONG_IMG_LEN} encoder keys, bf16, random init): "
              f"{len(long_preds)} prediction lines | {len(evals)} forwards launched "
              f"{long_counts} stage-mask kernels ({per_forward} each expected) | "
              f"{CLI_SIZES['test'] / long_forward_s:.2f} examples/s over the forwards | "
              f"main() {long_wall:.2f} s")
        out["launches"] = read_counts()
    finally:
        trainer_mod.train_step, trainer_mod.eval_step = train_step, eval_step
        run_pmr.eval_step, trainer_mod.Trainer.fit = eval_step, fit
        shutil.rmtree(tmp)
    check(out["launches"]["spec_attention"] > 0, f"phase 12 launches {out['launches']}")
    print(f"[12 cli] launches over the phase {out['launches']}")
    return out


def long_key_phase(rng) -> dict:
    """Phase 13: every route past the bf16 kernels' resident 192 keys and
    past the fp32 kernels' shared memory, against the plain versions at
    Lk 240 and 520; then bf16 kernel, plain version, SDPA and bound at
    (128, 240, 240, 12, 64) in the full and chunk stages and at the RoBERTa
    training shape with Lk 240 (128, 230, 240, 16, 64), dense forward and
    backward.  Returns the worst absolute error per kernel and the timings."""
    from multimodal_context_reasoning_torch.ops.flash import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )
    from multimodal_context_reasoning_torch.ops.fused_attention import (
        fused_attention,
        fused_attention_plain,
    )
    from multimodal_context_reasoning_torch.ops.masks import padding_bias
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
        spec_bias,
    )

    worst = {k: 0.0 for k in KERNELS}

    def hold(kernel, what, got, want, dtype, relative):
        err, rel = errors(got, want)
        ok = torch.isfinite(got).all().item() and (
            rel <= BWD_TOL[dtype] if relative else err <= TOL[dtype])
        check(ok, f"long keys {kernel} {what} {dtype}: abs {err} rel {rel}")
        worst[kernel] = max(worst[kernel], err)
        return f"{err:.2e}" + (f" ({rel:.1e} rel)" if relative else "")

    for L in LONG_KEYS:
        for dtype in (torch.float32, torch.bfloat16):
            line = []
            for stage in ("full", "chunk", "cross"):
                case = attention_case(rng, f"L={L} {stage}", 32, 140, L - 140, 12, stage)
                args = cuda_args(case, dtype)
                kw = dict(stage=case["stage"], text_len=case["text_len"])
                got = fused_attention_spec(*args, **kw)
                torch.cuda.synchronize()
                line.append(f"spec {stage} " + hold("spec_attention", f"{stage} L={L}", got,
                                                     spec_attention_plain(*args, **kw), dtype,
                                                     False))
                if stage == "chunk":   # its mask plane as the dense routes' bias
                    q, k, v, *vecs = args
                    plane = spec_bias(*vecs, stage="chunk", text_len=case["text_len"],
                                      lq=q.shape[1])
                    d_out = torch.randn(q.shape, device="cuda", dtype=dtype,
                                        generator=torch.Generator("cuda").manual_seed(L))
                del args, got
            row = dense_case(rng, 32, L - 10, 10, 12, 64)
            rq, rk, rv, rd = (row[n].to("cuda", dtype) for n in ("q", "k", "v", "d_out"))
            rbias = padding_bias(row["valid"].cuda())
            for name, (a, b_, c, bias, dout) in (("row", (rq, rk, rv, rbias, rd)),
                                                 ("plane", (q, k, v, plane, d_out))):
                got = fused_attention(a, b_, c, bias)
                torch.cuda.synchronize()
                line.append(f"dense {name} " + hold(
                    "fused_attention", f"{name} L={L}", got,
                    fused_attention_plain(a, b_, c, bias), dtype, name == "plane"))
                grads = flash_attention_bwd(a, b_, c, bias, dout, want_dbias=True)
                torch.cuda.synchronize()
                want = flash_attention_bwd_plain(a, b_, c, bias, dout)
                line.append(f"backward {name} " + ", ".join(
                    f"{out} " + hold("flash_bwd", f"{out} {name} L={L}", g, w, dtype, True)
                    for out, g, w in zip(("dq", "dk", "dv", "dbias"), grads, want)))
                del got, grads, want
            # a batch row with no valid key, through all three
            masked = attention_case(rng, "masked", 4, 140, L - 140, 4, "chunk")
            masked["vecs"] = (torch.zeros_like(masked["vecs"][0]),) + masked["vecs"][1:]
            mq, mk, mv, *mvecs = cuda_args(masked, dtype)
            got = fused_attention_spec(mq, mk, mv, *mvecs, stage="chunk",
                                       text_len=masked["text_len"])
            hold("spec_attention", f"masked L={L}", got,
                 spec_attention_plain(mq, mk, mv, *mvecs, stage="chunk",
                                      text_len=masked["text_len"]), dtype, False)
            mbias = padding_bias(mvecs[0])
            hold("fused_attention", f"masked L={L}", fused_attention(mq, mk, mv, mbias),
                 fused_attention_plain(mq, mk, mv, mbias), dtype, False)
            for g, w in zip(flash_attention_bwd(mq, mk, mv, mbias, torch.ones_like(mq)),
                            flash_attention_bwd_plain(mq, mk, mv, mbias, torch.ones_like(mq))):
                hold("flash_bwd", f"masked L={L}", g, w, dtype, True)
            line.append("fully masked rows finite and as plain")
            print(f"[13 long keys] Lk {L} {str(dtype):15s} " + " | ".join(line))
            if L == LONG_KEYS[0] and dtype == torch.bfloat16:
                same = [torch.equal(fused_attention_spec(q, k, v, *vecs, stage="chunk",
                                                         text_len=140),
                                    fused_attention_spec(q, k, v, *vecs, stage="chunk",
                                                         text_len=140)),
                        torch.equal(fused_attention(q, k, v, plane),
                                    fused_attention(q, k, v, plane))]
                runs = [flash_attention_bwd(q, k, v, plane, d_out, want_dbias=False)[:3]
                        for _ in range(2)]
                same.append(all(torch.equal(a, b_) for a, b_ in zip(*runs)))
                print(f"[13 long keys] bf16 two launches at Lk {L}: stage-mask, dense "
                      f"forward, backward dq/dk/dv bit-equal {same}")
                check(all(same), "long keys: two bf16 launches differ")
                del runs
            del q, k, v, plane, d_out, rq, rk, rv, rd, rbias
    print(f"[13 long keys] worst |kernel - plain| {worst} (forward tol {TOL}, backward and "
          f"plane-bias tol of max |plain| {BWD_TOL})")

    timed = {k: [] for k in KERNELS}
    dt = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for stage in ("full", "chunk"):
        case = attention_case(rng, f"(128, 240, 240, 12, 64) {stage}", 128, 140, 100, 12,
                              stage)
        args = cuda_args(case, dt)
        kw = dict(stage=case["stage"], text_len=case["text_len"])
        kernel = lambda: fused_attention_spec(*args, **kw)
        lib = sdpa_call(*args, case)
        b_ms, b_by = bound(case, dt)
        row = dict(shape=case["name"], ms=median_ms(kernel), b2b_ms=back_to_back_ms(kernel),
                   plain_ms=median_ms(lambda: spec_attention_plain(*args, **kw)),
                   library_ms=median_ms(lib), library_b2b_ms=back_to_back_ms(lib),
                   bound_ms=b_ms, bound_by=b_by)
        timed["spec_attention"].append(row)
        del args
    case = dense_case(rng, 128, 230, 10, 16, 64)
    q, k, v, d_out = (case[n].to("cuda", dt) for n in ("q", "k", "v", "d_out"))
    bias = padding_bias(case["valid"].cuda())
    mask = bias.to(dt)
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    qt, kt, vt = (t.detach().requires_grad_() for t in (q4, k4, v4))
    out_t = sdpa(qt, kt, vt, attn_mask=mask)
    d_out_t = d_out.transpose(1, 2)
    for name, kind, kernel, plain, lib in (
        ("fused_attention", "forward", lambda: fused_attention(q, k, v, bias),
         lambda: fused_attention_plain(q, k, v, bias),
         lambda: sdpa(q4, k4, v4, attn_mask=mask)),
        ("flash_bwd", "backward",
         lambda: flash_attention_bwd(q, k, v, bias, d_out, want_dbias=False),
         lambda: flash_attention_bwd_plain(q, k, v, bias, d_out),
         lambda: torch.autograd.grad(out_t, (qt, kt, vt), d_out_t, retain_graph=True)),
    ):
        b_ms, b_by = train_bound(case, dt, kind)
        timed[name].append(dict(
            shape="(128, 230, 240, 16, 64), bias [B, 1, 1, Lk]", ms=median_ms(kernel),
            b2b_ms=back_to_back_ms(kernel), plain_ms=median_ms(plain),
            library_ms=median_ms(lib), library_b2b_ms=back_to_back_ms(lib), bound_ms=b_ms,
            bound_by=b_by))
    for name, rows in timed.items():
        for r in rows:
            print(f"[13 long keys time] {name:16s} bf16 {r['shape']:44s} per call: kernel "
                  f"{r['ms']:.4f} | plain {r['plain_ms']:.4f} | sdpa {r['library_ms']:.4f} ms; "
                  f"back to back: kernel {r['b2b_ms']:.4f} | sdpa {r['library_b2b_ms']:.4f} ms "
                  f"| bound {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel at "
                  f"{r['bound_ms'] / r['b2b_ms']:.2%} of it")
    return dict(max_abs_err=worst, timed=timed, largest_lk=max(LONG_KEYS))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(port: int, path: str, body=None, timeout: float = 120.0):
    """(status, JSON reply, seconds) of one request to the local server."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, out = r.status, json.load(r)
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read() or b"{}")
    return code, out, time.perf_counter() - t0


def http_load(port: int, plan) -> tuple:
    """Each client of ``plan`` (a list of request bodies per client) sends its
    requests one after another, all clients at once; returns the replies as
    ``plan`` lays them out and the wall seconds from the first send to the
    last reply."""
    replies = [[None] * len(bodies) for bodies in plan]
    barrier = threading.Barrier(len(plan))

    def client(c):
        barrier.wait(timeout=60)
        for r, body in enumerate(plan[c]):
            replies[c][r] = http(port, "/score", body)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(plan)) as pool:
        list(pool.map(client, range(len(plan))))
    return replies, time.perf_counter() - t0


def load_summary(replies, wall: float, direct: dict, what: str) -> dict:
    """Check every reply of an HTTP load (200, finite logits that agree with
    direct scoring within 2e-2 of max |logit|, the same prediction wherever
    the direct top two logits are more than twice that apart) and sum it up:
    examples/s, p50/p99 request latency."""
    flat = [x for row in replies for x in row]
    codes = sorted({code for code, _, _ in flat})
    check(codes == [200], f"{what}: reply codes {codes}")
    got = {r["example_id"]: np.asarray(r["logits"]) for _, out, _ in flat
           for r in out["results"]}
    check(set(got) == set(direct) and all(np.isfinite(g).all() for g in got.values()),
          f"{what}: {len(got)} finite replies for {len(direct)} examples")
    tol = 2e-2 * max(np.abs(w).max() for w in direct.values())
    err = max(np.abs(got[e] - direct[e]).max() for e in direct)
    decided = [e for e in direct if np.diff(np.sort(direct[e])[-2:])[0] > 2 * tol]
    flipped = [e for e in decided if got[e].argmax() != direct[e].argmax()]
    check(err <= tol and not flipped,
          f"{what}: max |http - direct| {err} (tol {tol}), predictions differ at {flipped}")
    lat = np.asarray([t for _, _, t in flat]) * 1e3
    return dict(examples=len(got), requests=len(flat), wall_s=wall,
                examples_per_s=len(got) / wall, p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), max_abs_diff=err, tol=tol,
                predictions_checked=len(decided))


def serve_phase(rng) -> dict:
    """Phase 14, the slice's main path: ``python -m
    multimodal_context_reasoning_torch.cli.serve`` as a subprocess at full
    width in bf16, micro-batch 8, loaded by concurrent clients through HTTP
    and held against direct ``ModCRScorer.score`` of the same examples; then
    the same load in-process through ``serve(block=False)`` on the direct
    scorer, with the kernel counts set to 0 before and read after."""
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.data.feature_store import write_pack
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.server import serve
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    cfg = ModCRConfig().with_dtype("bfloat16")   # the serve command's, alignment on
    sizes = rng.integers(SERVE_EXAMPLES[0], SERVE_EXAMPLES[1] + 1,
                         (SERVE_CLIENTS, SERVE_REQUESTS))
    feats, examples = synthetic_requests(rng, int(sizes.sum()) + SERVE_CLIENTS, cfg,
                                         first=50_000)
    as_json = lambda ex: {"example_id": ex.example_id, "img_id": ex.img_id,
                          "premise": ex.premise, "answer_choices": ex.answer_choices}
    warm_plan = [[{"examples": [as_json(ex)]}] for ex in examples[:SERVE_CLIENTS]]
    it = iter(examples[SERVE_CLIENTS:])
    plan = [[{"examples": [as_json(next(it)) for _ in range(n)]} for n in row]
            for row in sizes]
    measured = examples[SERVE_CLIENTS:]
    tmp = tempfile.mkdtemp(prefix="modcr_serve_")
    pack = os.path.join(tmp, "feats.mcrpack")
    write_pack({k: v.features for k, v in feats.items()}, pack)
    out: dict = {}
    try:
        # 1. the command, a process of its own
        port = free_port()
        log_path = os.path.join(tmp, "serve.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "multimodal_context_reasoning_torch.cli.serve",
                 "--port", str(port), "--img_feat_file", pack,
                 "--micro_batch", str(SERVE_MICRO_BATCH), "--compute_dtype", "bfloat16"],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while True:
                check(proc.poll() is None, "the serve command exited: "
                      + open(log_path).read()[-2000:])
                check(time.perf_counter() - t0 < 600, "no /healthz within 600 s")
                try:
                    if http(port, "/healthz", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.5)
            startup = time.perf_counter() - t0
            http_load(port, warm_plan)
            replies, wall = http_load(port, plan)
            stats = http(port, "/stats")[1]
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
                exited = True
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                exited = False
        check(exited, "the serve command did not exit on SIGTERM")
        started = [ln for ln in open(log_path).read().splitlines() if "serving on" in ln]
        print(f"[14 serve] the command: {started} after {startup:.2f} s (model build, "
              f"kernel load, warm-up) | exit code {proc.returncode} after SIGTERM")

        # 2. direct scoring of the same examples, the same weights (seed 0)
        model = ModCRModel(cfg, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
        scorer = ModCRScorer(cfg, model, *hash_tokenizers(cfg), feats,
                             micro_batch=SERVE_MICRO_BATCH, device="cuda")
        scorer.warm_up()
        # seconds of each score_featurized call (collate, copy, forward and
        # the logits' readback): does the load slow the forward, or idle it?
        calls = []
        score_featurized = scorer.score_featurized

        def timed_score(feats_, ids):
            t = time.perf_counter()
            res = score_featurized(feats_, ids)
            calls.append(time.perf_counter() - t)
            return res

        scorer.score_featurized = timed_score
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = scorer.score(measured)
        torch.cuda.synchronize()
        direct_wall = time.perf_counter() - t0
        direct_calls = calls[:]
        direct = {r["example_id"]: np.asarray(r["logits"]) for r in rows}
        route = stats["routes"]["score"]
        out["http_command"] = dict(load_summary(replies, wall, direct, "serve command"),
                                   startup_s=startup,
                                   forwards=route["device_dispatches"],
                                   mean_dispatch=route["mean_device_batch"])
        out["direct"] = dict(examples=len(rows), wall_s=direct_wall,
                             examples_per_s=len(rows) / direct_wall,
                             forwards=len(direct_calls),
                             ms_per_forward=1e3 * statistics.mean(direct_calls),
                             forward_share=sum(direct_calls) / direct_wall)

        # 3. the same load in-process, counting the kernel launches
        server = serve(scorer, "127.0.0.1", 0, block=False)
        try:
            sport = server.server_address[1]
            http_load(sport, warm_plan)
            before = server.modcr_batcher.telemetry()
            torch.cuda.synchronize()
            del calls[:]
            reset_counts()
            replies, wall = http_load(sport, plan)
            torch.cuda.synchronize()
            launches = read_counts()
            load_calls = calls[:]
            dispatched = server.modcr_batcher.telemetry()[len(before):]
        finally:
            server.modcr_close()
        per_forward = spec_launches_per_eval_forward(cfg)
        out["http_in_process"] = dict(load_summary(replies, wall, direct, "in-process serve"),
                                      forwards=len(dispatched),
                                      mean_dispatch=sum(dispatched) / len(dispatched),
                                      ms_per_forward=1e3 * statistics.mean(load_calls),
                                      forward_share=sum(load_calls) / wall)
        check(launches["spec_attention"] == per_forward * len(dispatched),
              f"serving launches {launches} over {len(dispatched)} forwards, "
              f"{per_forward} stage-mask launches each expected")
        out["launches"] = launches
        out["launches_per_forward"] = per_forward
        del scorer, model
    finally:
        shutil.rmtree(tmp)
    for name in ("http_command", "http_in_process"):
        r = out[name]
        print(f"[14 serve] {name}: {SERVE_CLIENTS} clients x {SERVE_REQUESTS} requests of "
              f"{SERVE_EXAMPLES[0]}-{SERVE_EXAMPLES[1]} examples ({r['examples']} examples): "
              f"{r['examples_per_s']:.2f} ex/s over {r['wall_s']:.3f} s | request latency p50 "
              f"{r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms | {r['forwards']} forwards, mean "
              f"dispatch {r['mean_dispatch']:.2f} examples | max |http - direct| "
              f"{r['max_abs_diff']:.3e} (tol {r['tol']:.3e}), {r['predictions_checked']} "
              f"predictions held")
    d, h = out["direct"], out["http_in_process"]
    print(f"[14 serve] direct ModCRScorer.score at micro-batch {SERVE_MICRO_BATCH}, the same "
          f"{d['examples']} examples in order: {d['examples_per_s']:.2f} ex/s "
          f"({d['forwards']} forwards, {d['wall_s']:.3f} s)")
    print(f"[14 serve] score_featurized (collate, copy, forward, readback) per call: direct "
          f"{d['ms_per_forward']:.2f} ms, {d['forward_share']:.1%} of the wall | under the "
          f"in-process HTTP load {h['ms_per_forward']:.2f} ms, {h['forward_share']:.1%} of the "
          f"wall (the rest: the dispatcher waiting for featurized examples)")
    print(f"[14 serve] in-process launches {out['launches']} = {out['launches_per_forward']} "
          f"stage-mask launches x {out['http_in_process']['forwards']} forwards")
    return out


# ---------------------------------------------------------------- main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.ops.build import load_library
    from multimodal_context_reasoning_torch.ops.spec_attention import (
        fused_attention_spec,
        spec_attention_plain,
    )
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.synthetic import (
        hash_tokenizers,
        synthetic_requests,
    )

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    print(card)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(load_library, KERNELS)))
    for name, (_, log, build_s) in built.items():
        ptxas = []  # per kernel instance: its name, registers and spill bytes
        for ln in log.splitlines():
            entry = re.search(r"entry function '.*?\d([a-z][a-z_]*_kernel)"
                              r"(?:I(?:Li(\d+)E)?(?:\w*?\d([A-Z][A-Za-z]*?(?:Bias|Stage)))?)?",
                              ln)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            regs = re.search(r"Used (\d+) registers", ln)
            if entry:
                args = ",".join(a for a in entry.group(2, 3) if a)
                ptxas.append(entry.group(1) + (f"<{args}>" if args else "") + ":")
            elif spill:
                ptxas.append(f"spill {spill.group(1)}/{spill.group(2)} B,")
            elif regs:
                ptxas.append(f"{regs.group(1)} regs;")
        print(f"[2 build] {name}.cu: nvcc {build_s:.2f} s | " + " ".join(ptxas))
    print(f"[2 build] all {len(KERNELS)} built and loaded in {time.perf_counter() - t0:.2f} s")

    # 3. kernel vs plain, at the shapes of both served micro-batches
    rng = np.random.default_rng(SEED)
    cases = {mb: shapes(rng, mb) for mb in MICRO_BATCHES}
    max_err = 0.0
    for case, _ in cases[8] + cases[32]:
        for dtype in (torch.float32, torch.bfloat16):
            args = cuda_args(case, dtype)
            kw = dict(stage=case["stage"], text_len=case["text_len"])
            got = fused_attention_spec(*args, **kw)
            torch.cuda.synchronize()
            want = spec_attention_plain(*args, **kw)
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            print(f"[3 check] {case['name']:33s} {str(dtype):15s} max|kernel-plain| "
                  f"{err:.3e} (tol {TOL[dtype]:g})")
            check(torch.isfinite(got).all().item(), f"non-finite output {case['name']}")
            check(err <= TOL[dtype], f"{case['name']} {dtype}: {err} > {TOL[dtype]}")
            del args, got, want
    masked = attention_case(rng, "fully masked rows", 4, 30, 10, 4, "chunk")
    masked["vecs"] = (torch.zeros_like(masked["vecs"][0]),) + masked["vecs"][1:]
    for dtype in (torch.float32, torch.bfloat16):
        args = cuda_args(masked, dtype)
        kw = dict(stage="chunk", text_len=masked["text_len"])
        got = fused_attention_spec(*args, **kw)
        want = spec_attention_plain(*args, **kw)
        err = (got.float() - want.float()).abs().max().item()
        print(f"[3 check] {'fully masked rows':33s} {str(dtype):15s} finite="
              f"{torch.isfinite(got).all().item()} max|kernel-plain| {err:.3e}")
        check(torch.isfinite(got).all().item() and err <= TOL[dtype], "fully masked rows")
    for case, _ in cases[8][1:3]:   # the chunk and full stages at L = 190
        args = cuda_args(case, torch.bfloat16)
        kw = dict(stage=case["stage"], text_len=case["text_len"])
        same = torch.equal(fused_attention_spec(*args, **kw), fused_attention_spec(*args, **kw))
        print(f"[3 check] {case['name']:33s} bf16, two launches bit-equal {same}")
        check(same, f"{case['name']}: two bf16 launches differ")

    # 4. timing (bf16, the serving dtype), at micro-batch 8
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, b2b_ms=0.0,
                  library_b2b_ms=0.0)
    bytes_share = 0.0
    per_shape = []
    for case, n_fwd in cases[8]:
        args = cuda_args(case, torch.bfloat16)
        kw = dict(stage=case["stage"], text_len=case["text_len"])
        kernel = lambda: fused_attention_spec(*args, **kw)
        sdpa = sdpa_call(*args, case)
        ms = median_ms(kernel)
        plain_ms = median_ms(lambda: spec_attention_plain(*args, **kw))
        lib_ms = median_ms(sdpa)
        b2b_ms, lib_b2b_ms = back_to_back_ms(kernel), back_to_back_ms(sdpa)
        b_ms, b_by = bound(case, torch.bfloat16)
        per_shape.append(dict(shape=case["name"], launches_per_forward=n_fwd, ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by, b2b_ms=b2b_ms, library_b2b_ms=lib_b2b_ms))
        print(f"[4 time] {case['name']:33s} kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
              f"sdpa {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) | "
              f"{n_fwd} per forward")
        print(f"[4 time] {case['name']:33s} 25 back to back, per launch: kernel "
              f"{b2b_ms:.4f} ms ({b_ms / b2b_ms:.2%} of its bound) | sdpa {lib_b2b_ms:.4f} ms "
              f"| kernel / sdpa {b2b_ms / lib_b2b_ms:.2f}")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("library_ms", lib_ms), ("b2b_ms", b2b_ms),
                         ("library_b2b_ms", lib_b2b_ms)):
            totals[key] += n_fwd * val
        if b_by == "bytes":
            bytes_share += n_fwd * b_ms
    print("[4 time] one micro-batch-8 forward's 60 launches: " + " | ".join(
        f"{k} {v:.4f}" for k, v in totals.items()))
    train_spec = time_training_spec_shapes(rng)

    # 5. end-to-end parity, full width fp32: card (kernel) vs CPU (plain)
    # serving needs logits only: no alignment loss, so no layer returns
    # probabilities and every attention with a mask spec takes the kernel
    cfg32 = dataclasses.replace(ModCRConfig(), compute_alignment=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = ModCRModel(cfg32, device="cuda", generator=gen)
    cpu_model = copy.deepcopy(model).cpu()
    bert, rob = hash_tokenizers(cfg32)
    parity_feats, parity_reqs = synthetic_requests(rng, 1, cfg32)
    gpu_rows = ModCRScorer(cfg32, model, bert, rob, parity_feats, micro_batch=1,
                           device="cuda").score(parity_reqs)
    t0 = time.perf_counter()
    cpu_rows = ModCRScorer(cfg32, cpu_model, bert, rob, parity_feats, micro_batch=1,
                           device="cpu").score(parity_reqs)
    cpu_s = time.perf_counter() - t0
    del cpu_model
    g, c = np.asarray(gpu_rows[0]["logits"]), np.asarray(cpu_rows[0]["logits"])
    e2e_err = float(np.abs(g - c).max())
    print(f"[5 parity] full-width fp32, 1 example (4 rows): cuda {np.round(g, 5).tolist()} "
          f"cpu {np.round(c, 5).tolist()} max|diff| {e2e_err:.3e} (tol 1e-3) | "
          f"pred {gpu_rows[0]['prediction']} vs {cpu_rows[0]['prediction']} | "
          f"cpu forward {cpu_s:.1f} s")
    check(np.isfinite(g).all() and e2e_err <= 1e-3, "end-to-end logits disagree")
    check(gpu_rows[0]["prediction"] == cpu_rows[0]["prediction"], "predictions differ")

    # 6. serving, the main path: full-width bf16 scorer, same weights
    cfg16 = cfg32.with_dtype("bfloat16")
    model16 = ModCRModel(cfg16, device="cuda")
    model16.load_state_dict(model.state_dict())
    del model
    torch.cuda.empty_cache()
    reset_counts()
    forwards = 0
    serving = {}
    for mb, n_chunks in zip(MICRO_BATCHES, (8, 4)):
        feats, reqs = synthetic_requests(rng, mb * (n_chunks + 1), cfg16, first=1000 * mb)
        scorer = ModCRScorer(cfg16, model16, bert, rob, feats, micro_batch=mb,
                             device="cuda")
        before = fused_attention_spec.launches
        rows = scorer.score(reqs[:mb])  # warm-up micro-batch
        forwards += 1
        check(fused_attention_spec.launches - before == LAUNCHES_PER_FORWARD,
              f"mb {mb}: {fused_attention_spec.launches - before} launches in one forward")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = scorer.score(reqs[mb:])
        wall = time.perf_counter() - t0
        forwards += n_chunks
        logits = np.asarray([r["logits"] for r in rows])
        check(logits.shape == (mb * n_chunks, cfg16.num_labels), f"logits {logits.shape}")
        check(np.isfinite(logits).all(), f"non-finite bf16 logits at mb {mb}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        serving[mb] = dict(examples_per_s=len(rows) / wall,
                           ms_per_micro_batch=1e3 * wall / n_chunks, peak_gib=peak)
        print(f"[6 serve] bf16 micro_batch {mb} ({mb * cfg16.num_labels} rows): "
              f"{len(rows)} examples in {wall:.3f} s = {len(rows) / wall:.2f} ex/s, "
              f"{1e3 * wall / n_chunks:.2f} ms per micro-batch, peak {peak:.2f} GiB "
              f"(host featurize included)")
    serve_counts = read_counts()
    launches = serve_counts["spec_attention"]
    print(f"[6 serve] {forwards} forwards, launches {serve_counts} "
          f"(spec_attention = {LAUNCHES_PER_FORWARD} x {forwards})")
    check(launches == LAUNCHES_PER_FORWARD * forwards, "launch count on the serving path")
    bf16_logits = np.asarray(ModCRScorer(
        cfg16, model16, bert, rob, parity_feats, micro_batch=1, device="cuda",
    ).score(parity_reqs)[0]["logits"])
    print(f"[6 serve] phase-5 request in bf16: {np.round(bf16_logits, 5).tolist()}, "
          f"max|bf16-fp32| {np.abs(bf16_logits - g).max():.3e} (not a check)")
    del model16, scorer
    torch.cuda.empty_cache()

    # 7-8. the training kernels against their plain versions, then timed
    train_err = check_training_kernels(rng)
    train_times = time_training_kernels(rng)
    torch.cuda.empty_cache()

    # 9. training parity, card against CPU
    parity = training_parity(rng)
    torch.cuda.empty_cache()

    # 10. training, the slice's main path
    train = train_slice(rng)
    torch.cuda.empty_cache()

    # 12. the two commands at full width (before 11's closing lines)
    cli = cli_phase(rng)
    torch.cuda.empty_cache()

    # 13. every route at long keys
    long_keys = long_key_phase(rng)
    torch.cuda.empty_cache()

    # 14. the serve command, the slice's main path
    served = serve_phase(rng)

    # 11. kernels line, then the result line
    print(card)
    print(json.dumps({"serving": serving, "e2e_fp32_max_abs_diff": e2e_err,
                      "train_parity_max_rel_diff": parity["max_rel_diff"],
                      "training": {k: v for k, v in train.items() if k != "launches"},
                      "cli": {k: v for k, v in cli.items() if k != "launches"},
                      "serve": {k: v for k, v in served.items() if k != "launches"}}))
    main_path = train["launches"]
    shape = "bf16 (128, 128, 138, 16, 64), one launch, as one RoBERTa layer of the slice"

    def long_key_row(name):
        return dict(largest_lk=long_keys["largest_lk"],
                    max_abs_err=long_keys["max_abs_err"][name], timed=long_keys["timed"][name])
    print(json.dumps({"kernels": [{
        "name": "spec_attention",
        "route": "cuda",
        "source": "multimodal_context_reasoning_torch/csrc/spec_attention.cu",
        "replaces": "multimodal_context_reasoning_tpu/ops/pallas_attention.py:187",
        "launches": main_path["spec_attention"],
        "serving_launches": launches,
        "cli_launches": cli["launches"]["spec_attention"],
        "serve_launches": served["launches"]["spec_attention"],
        "max_abs_err": max(max_err, train_err["spec_attention"],
                           long_keys["max_abs_err"]["spec_attention"]),
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if bytes_share >= totals["bound_ms"] / 2 else "operations",
        "library_ms": totals["library_ms"],
        "b2b_ms": totals["b2b_ms"],
        "library_b2b_ms": totals["library_b2b_ms"],
        "timed_as": "sum over one micro-batch-8 forward's 60 launches, bf16 (ms, plain_ms, "
                    "library_ms per call; b2b_ms, library_b2b_ms back to back)",
        "shapes": per_shape,
        "training_shapes": train_spec,
        "long_keys": long_key_row("spec_attention"),
    }, {
        "name": "fused_attention",
        "route": "cuda",
        "source": "multimodal_context_reasoning_torch/csrc/fused_attention.cu",
        "replaces": "multimodal_context_reasoning_tpu/ops/pallas_attention.py:73",
        "launches": main_path["fused_attention"],
        "cli_launches": cli["launches"]["fused_attention"],
        "serve_launches": served["launches"]["fused_attention"],
        "max_abs_err": max(train_err["fused_attention"],
                           long_keys["max_abs_err"]["fused_attention"]),
        **train_times["fused_attention"],
        "timed_as": shape,
        "long_keys": long_key_row("fused_attention"),
    }, {
        "name": "flash_bwd",
        "route": "cuda",
        "source": "multimodal_context_reasoning_torch/csrc/flash_bwd.cu",
        "replaces": "multimodal_context_reasoning_tpu/ops/flash.py:190",
        "launches": main_path["flash_bwd"],
        "cli_launches": cli["launches"]["flash_bwd"],
        "serve_launches": served["launches"]["flash_bwd"],
        "max_abs_err": max(train_err["flash_bwd"], long_keys["max_abs_err"]["flash_bwd"]),
        **train_times["flash_bwd"],
        "timed_as": shape + ", no dbias plane",
        "long_keys": long_key_row("flash_bwd"),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
