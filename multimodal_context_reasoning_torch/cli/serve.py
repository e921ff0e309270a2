"""Serving entry point (port of the JAX package's ``cli/serve.py``, its score
endpoint)::

    python -m multimodal_context_reasoning_torch.cli.serve \\
        --img_feat_file feats.mcrpack --eval_model_dir output/pmr --port 8477

The model runs on the GPU (``--device``, default ``cuda``; without a card the
command raises, ``--device cpu`` asks for the CPU).  ``--eval_model_dir``
takes a ``run_pmr --do_train`` output directory: its ``config.json`` and the
best-accuracy parameters under ``ckpt/``; without it the weights are a
seeded random init.  The scorer is built and warmed (its first forward
builds the kernels on the card) before the "serving on" line is printed.
Flags the port does not honour yet are refused before any data is read,
each with the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import os

import torch


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ModCR scoring server (PyTorch/CUDA port)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8477)
    p.add_argument("--img_feat_file", required=True)
    p.add_argument("--eval_model_dir", default="",
                   help="a run_pmr --do_train output directory: config.json and "
                        "the best checkpoint under ckpt/ (random init if unset)")
    p.add_argument("--bert_tokenizer_dir", default="",
                   help="refused: needs transformers (ROADMAP Queue 1 item 11)")
    p.add_argument("--roberta_tokenizer_dir", default="",
                   help="refused: needs transformers (ROADMAP Queue 1 item 11)")
    p.add_argument("--micro_batch", type=int, default=8)
    p.add_argument("--params_dtype", default=None,
                   choices=("float32", "float16", "bfloat16"),
                   help="round every floating-point weight once at load to this "
                        "dtype, as the JAX scorer casts its resident params; the "
                        "port's scorer then holds each tower's weights at its "
                        "compute dtype (bf16 at full width), so this changes "
                        "scores only where the two differ (e.g. bfloat16 with "
                        "--tiny, which computes in fp32)")
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="W8A8 int8; refused (ROADMAP Queue 1 item 6)")
    p.add_argument("--compute_dtype", default="bfloat16", choices=("float32", "bfloat16"))
    p.add_argument("--device_features", action="store_true",
                   help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--generate", action="store_true",
                   help="POST /generate; refused (ROADMAP Queue 1 item 7)")
    p.add_argument("--rationale_ckpt", default="",
                   help="refused (ROADMAP Queue 1 item 7)")
    p.add_argument("--gpt_tokenizer_dir", default="",
                   help="refused (ROADMAP Queue 1 item 7)")
    p.add_argument("--max_rationale_len", type=int, default=32,
                   help="taken and unused: /generate is not ported")
    p.add_argument("--gen_micro_batch", type=int, default=4,
                   help="taken and unused: /generate is not ported")
    p.add_argument("--artifact", default="", help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--save_artifact", default="", help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--gen_artifact", default="", help="refused (ROADMAP Queue 1 item 7)")
    p.add_argument("--save_gen_artifact", default="",
                   help="refused (ROADMAP Queue 1 item 7)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--max_queue_batches", type=int, default=8,
                   help="back-pressure: shed (HTTP 429) beyond this many "
                        "micro-batches of queued work")
    p.add_argument("--deadline_ms", type=float, default=None,
                   help="default per-request deadline; expired work gets HTTP 503")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: a CUDA device (the default; "
                        "raises without a card) or 'cpu'")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from multimodal_context_reasoning_torch.cli.common import (
        load_image_features,
        load_tokenizers,
        refuse,
    )
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.core.device import resolve_device
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.server import serve
    from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager

    refuse([
        ("--quantize int8", args.quantize != "none", 6),
        ("--generate", args.generate, 7),
        ("--rationale_ckpt", bool(args.rationale_ckpt), 7),
        ("--gpt_tokenizer_dir", bool(args.gpt_tokenizer_dir), 7),
        ("--gen_artifact", bool(args.gen_artifact), 7),
        ("--save_gen_artifact", bool(args.save_gen_artifact), 7),
        ("--artifact", bool(args.artifact), 9),
        ("--save_artifact", bool(args.save_artifact), 9),
        ("--device_features", args.device_features, 9),
        ("--bert_tokenizer_dir", bool(args.bert_tokenizer_dir), 11),
        ("--roberta_tokenizer_dir", bool(args.roberta_tokenizer_dir), 11),
    ])
    device = resolve_device(args.device)
    cfg = ModCRConfig.tiny() if args.tiny else ModCRConfig().with_dtype(args.compute_dtype)
    cfg_path = os.path.join(args.eval_model_dir, "config.json")
    if args.eval_model_dir and os.path.exists(cfg_path):
        # the geometry the checkpoint was trained at (run_pmr --do_test)
        with open(cfg_path) as f:
            cfg = ModCRConfig.from_json(f.read())

    feats = load_image_features(args.img_feat_file, cfg.global_encoder.img_feature_dim)
    bert, rob = load_tokenizers(args, cfg)
    if args.eval_model_dir:
        # params only, the best-accuracy save: serving does not depend on
        # the training run's optimizer state
        weights = CheckpointManager(
            os.path.join(args.eval_model_dir, "ckpt")).restore_params(best=True)
    else:
        weights = ModCRModel(cfg, device=device,
                             generator=torch.Generator(device=device).manual_seed(0))
    if args.params_dtype:
        dt = getattr(torch, args.params_dtype)
        tensors = weights.state_dict() if isinstance(weights, ModCRModel) else weights
        with torch.no_grad():
            for t in tensors.values():
                if t.is_floating_point():
                    t.copy_(t.to(dt))

    scorer = ModCRScorer(cfg, weights, bert, rob, feats, micro_batch=args.micro_batch,
                         device=device)
    scorer.warm_up()
    print(f"serving on http://{args.host}:{args.port} (micro_batch={args.micro_batch}, "
          f"{device}, {cfg.global_encoder.dtype})", flush=True)
    serve(scorer, args.host, args.port, max_queue_batches=args.max_queue_batches,
          default_deadline_ms=args.deadline_ms)


if __name__ == "__main__":
    main()
