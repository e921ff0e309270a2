"""Hold the bf16 attention kernels of two checkouts to the same bits.

Runs the three CUDA kernels of the port (the stage-mask forward, the
dense-bias forward and the backward) in bf16 at head dims 64 and 128 (the
tensor-core instances) on inputs made from a fixed seed, at the shapes of
the slice's main paths at the production widths (the encoders' three
stages at (32, 190, 190, 12, 64) and (32, 190, 190, 6, 128), RoBERTa's
(128, 128, 138, 16, 64) and (128, 128, 138, 8, 128), and 240 keys, which
take the key-looped instances; at Dh 128 also RoBERTa with no prefix, 128
keys, which the resident backward holds), and either saves the outputs or
compares them with saved ones bit for bit (dq, dk and dv; the
dbias plane sums over heads with atomics, so it is compared to 1e-6 of its
largest value).  Every kernel is launched through the checkout named by
``--root``, so one checkout's build can be held against another's:

    python3 scripts/torch_kernel_bits.py --root OLD --save old.pt
    python3 scripts/torch_kernel_bits.py --compare old.pt

``--time`` also times each case back to back (25 launches in one window of
CUDA events, over 25; the median of 5 windows).  Needs a CUDA card; prints
one line per output and exits non-zero when any differs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

SEED = 6


def cases(rng, dh: int, enc_heads: int, rob_heads: int, prefixes=(10,)):
    """(name, kind, args) at the bf16 shapes of head dim ``dh``, inputs from
    ``rng``; RoBERTa with each of ``prefixes`` prefix keys."""
    from multimodal_context_reasoning_torch.ops.masks import padding_bias, stage_mask_specs
    from multimodal_context_reasoning_torch.ops.spec_attention import spec_bias

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().bfloat16()

    out = []
    for L in (190, 240):
        B, T, H = 32, 140, enc_heads
        text_mask = np.zeros((B, T), np.float32)
        gi = np.full((B, T), -1, np.int32)
        for b, n in enumerate(rng.integers(20, T + 1, B)):
            text_mask[b, :n] = 1.0
            gi[b, 1:n - 1] = np.arange(n - 2) // 3
        img_mask = np.zeros((B, L - T), np.float32)
        for b, n in enumerate(rng.integers(10, L - T + 1, B)):
            img_mask[b, :n] = 1.0
        specs = stage_mask_specs(*(torch.from_numpy(x).cuda() for x in (text_mask, img_mask, gi)))
        q, k, v, d_out = (normal(B, L, H, dh) for _ in range(4))
        for spec in specs:
            vecs = (spec.valid, spec.gi, spec.rowfull)
            kw = dict(stage=spec.stage, text_len=spec.text_len)
            out.append((f"spec {spec.stage} ({B}, {L}, {L}, {H}, {dh})", "spec",
                        (q, k, v, *vecs), kw))
            bias = spec_bias(*vecs, **kw, lq=L)
            out.append((f"dense {spec.stage} plane ({B}, {L}, {L}, {H}, {dh})", "dense",
                        (q, k, v, bias), {}))
            out.append((f"backward {spec.stage} plane ({B}, {L}, {L}, {H}, {dh})", "backward",
                        (q, k, v, bias, d_out), {}))
    B, lq, H = 128, 128, rob_heads
    for P in prefixes:
        valid = np.zeros((B, P + lq), np.float32)
        valid[:, :P] = 1.0
        for b, n in enumerate(rng.integers(20, lq + 1, B)):
            valid[b, P:P + n] = 1.0
        valid = torch.from_numpy(valid).cuda()
        q, d_out = normal(B, lq, H, dh), normal(B, lq, H, dh)
        k, v = normal(B, P + lq, H, dh), normal(B, P + lq, H, dh)
        bias = padding_bias(valid)
        shape = f"({B}, {lq}, {P + lq}, {H}, {dh})"
        out.append((f"dense row {shape}", "dense", (q, k, v, bias), {}))
        out.append((f"backward row {shape}", "backward", (q, k, v, bias, d_out), {}))
        vecs = (valid, torch.full(valid.shape, -1, dtype=torch.int32, device="cuda"),
                torch.zeros_like(valid))
        out.append((f"spec roberta full {shape}", "spec", (q, k, v, *vecs),
                    dict(stage="full", text_len=lq)))
    return out


def b2b_ms(fn, n: int = 25, windows: int = 5) -> float:
    """Milliseconds per call of ``fn`` launched ``n`` times back to back,
    the median of ``windows`` windows of CUDA events."""
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
    return float(np.median(times))


def run(time_them: bool = False) -> dict:
    from multimodal_context_reasoning_torch.ops.flash import flash_attention_bwd
    from multimodal_context_reasoning_torch.ops.fused_attention import fused_attention
    from multimodal_context_reasoning_torch.ops.spec_attention import fused_attention_spec

    results = {}
    rng = np.random.default_rng(SEED)
    for name, kind, args, kw in cases(rng, 64, 12, 16) + cases(rng, 128, 6, 8, (10, 0)):
        if kind == "spec":
            fn = lambda: (fused_attention_spec(*args, **kw),)
        elif kind == "dense":
            fn = lambda: (fused_attention(*args),)
        else:
            fn = lambda: flash_attention_bwd(*args, want_dbias=True)
        results[name] = tuple(t.cpu() for t in fn())
        if time_them:
            print(f"{name}: b2b {b2b_ms(fn):.4f} ms")
    torch.cuda.synchronize()
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="the checkout whose port to launch (default: this one)")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--save", help="write the outputs to this file")
    group.add_argument("--compare", help="hold the outputs to the ones in this file")
    parser.add_argument("--time", action="store_true", help="also time each case b2b")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_bits: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import multimodal_context_reasoning_torch

    print(f"port from {Path(multimodal_context_reasoning_torch.__file__).parent}")
    got = run(args.time)
    if args.save:
        torch.save(got, args.save)
        print(f"saved {len(got)} cases to {args.save}")
        return 0
    want = torch.load(args.compare)
    ok = set(got) == set(want)
    for name, outs in got.items():
        ref = want[name]
        same = [torch.equal(a, b) for a, b in zip(outs[:3], ref[:3])]
        line = f"{name}: bit-equal {same}"
        if len(outs) == 4:   # the dbias plane: fp32 atomics
            err = (outs[3] - ref[3]).abs().max().item() / ref[3].abs().max().item()
            line += f", dbias within {err:.2e} of its max"
            same.append(err <= 1e-6)
        print(line)
        ok &= all(same)
    print(f"all {len(got)} cases equal: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
