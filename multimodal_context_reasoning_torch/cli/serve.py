"""Serving entry point (port of the JAX package's ``cli/serve.py``)::

    python -m multimodal_context_reasoning_torch.cli.serve \\
        --img_feat_file feats.mcrpack --eval_model_dir output/pmr --port 8477 \\
        [--quantize int8] [--generate [--rationale_ckpt best.pth]]

The model runs on the GPU (``--device``, default ``cuda``; without a card the
command raises, ``--device cpu`` asks for the CPU).  ``--eval_model_dir``
takes a ``run_pmr --do_train`` output directory: its ``config.json`` and the
best-accuracy parameters under ``ckpt/``; without it the weights are a
seeded random init.  ``--quantize int8`` scores through the W8A8 route
(ops/quant.py).  ``--generate`` also serves the rationale family at
``POST /generate`` (serving/generator.py): the ``--tiny`` geometry, or
``EncoderConfig()`` and ``GPT2Config()`` at full width, random init from a
seed or a reference ``ChunkAlign_CLS_dec5_4`` checkpoint
(``--rationale_ckpt``, its GPT-2 vocabulary sized to the checkpoint), and a
hash GPT tokenizer of that vocabulary.  The scorer and the generator are
built and warmed (the first forward builds the kernels on the card) before
the "serving on" line is printed.
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
                   help="dynamic W8A8 int8 matmuls (ops/quant.py)")
    p.add_argument("--compute_dtype", default="bfloat16", choices=("float32", "bfloat16"))
    p.add_argument("--device_features", action="store_true",
                   help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--generate", action="store_true",
                   help="also serve the rationale-generation family at "
                        "POST /generate (classify + KV-cached decode)")
    p.add_argument("--rationale_ckpt", default="",
                   help="reference ChunkAlign_CLS_dec5_4 torch checkpoint for "
                        "/generate (interop/assemble.py); random init if unset")
    p.add_argument("--gpt_tokenizer_dir", default="",
                   help="refused: needs transformers (ROADMAP Queue 1 item 11)")
    p.add_argument("--max_rationale_len", type=int, default=32)
    p.add_argument("--gen_micro_batch", type=int, default=4,
                   help="questions per /generate forward")
    p.add_argument("--artifact", default="", help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--save_artifact", default="", help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--gen_artifact", default="", help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--save_gen_artifact", default="",
                   help="refused (ROADMAP Queue 1 item 9)")
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
        ("--gen_artifact", bool(args.gen_artifact), 9),
        ("--save_gen_artifact", bool(args.save_gen_artifact), 9),
        ("--artifact", bool(args.artifact), 9),
        ("--save_artifact", bool(args.save_artifact), 9),
        ("--device_features", args.device_features, 9),
        ("--bert_tokenizer_dir", bool(args.bert_tokenizer_dir), 11),
        ("--roberta_tokenizer_dir", bool(args.roberta_tokenizer_dir), 11),
        ("--gpt_tokenizer_dir", bool(args.gpt_tokenizer_dir), 11),
    ])
    device = resolve_device(args.device)
    cfg = ModCRConfig.tiny() if args.tiny else ModCRConfig().with_dtype(args.compute_dtype)
    cfg_path = os.path.join(args.eval_model_dir, "config.json")
    if args.eval_model_dir and os.path.exists(cfg_path):
        # the geometry the checkpoint was trained at (run_pmr --do_test)
        with open(cfg_path) as f:
            cfg = ModCRConfig.from_json(f.read())
    if args.quantize != "none":
        cfg = cfg.with_quantize(args.quantize)

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
    generator = build_generator(args, cfg, bert, feats, device) if args.generate else None
    print(f"serving on http://{args.host}:{args.port} (micro_batch={args.micro_batch}, "
          f"{device}, {cfg.global_encoder.dtype}"
          f"{', int8' if args.quantize != 'none' else ''}"
          f"{', /generate on' if generator else ''})", flush=True)
    serve(scorer, args.host, args.port, generator=generator,
          max_queue_batches=args.max_queue_batches, default_deadline_ms=args.deadline_ms)


def build_generator(args, cfg, bert, feats, device):
    """The rationale family for POST /generate, as the JAX command builds
    it: the VCR-native classify tower and the GPT-2 cross-attention decoder,
    weights from a reference checkpoint or a seeded random init, the
    compute dtype of ``--compute_dtype`` for the encoders (the decoder is
    fp32), warmed before it returns."""
    from multimodal_context_reasoning_torch.core.config import (
        ChunkAlignConfig,
        EncoderConfig,
        GPT2Config,
    )
    from multimodal_context_reasoning_torch.data.collate import BatchSpec
    from multimodal_context_reasoning_torch.data.tokenization import HashTokenizer
    from multimodal_context_reasoning_torch.interop.assemble import load_rationale_checkpoint
    from multimodal_context_reasoning_torch.models.rationale import RationaleModel
    from multimodal_context_reasoning_torch.serving.generator import RationaleGenerator

    dt = args.compute_dtype
    if args.tiny:
        enc = EncoderConfig(
            vocab_size=cfg.global_encoder.vocab_size, hidden_size=32, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, max_position_embeddings=128,
            img_feature_dim=cfg.global_encoder.img_feature_dim, dtype=dt)
        sched = ChunkAlignConfig(chunk_layers_end=1, full_layers_end=2)
        gpt = GPT2Config(vocab_size=128, n_positions=128, n_embd=32, n_layer=2, n_head=4,
                         resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, pad_token_id=0,
                         dtype=dt)
        max_chunks = cfg.max_chunks
    else:
        enc = EncoderConfig(dtype=dt)             # Oscar-base geometry
        sched = ChunkAlignConfig()
        gpt = GPT2Config(dtype=dt)                # GPT-2 124M geometry
        max_chunks = 40
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len, roberta_len=cfg.roberta_len,
                     img_feature_dim=enc.img_feature_dim)
    seeded = torch.Generator(device=device).manual_seed(0)
    if args.rationale_ckpt:
        vocab = gpt.vocab_size
        model, gpt, report = load_rationale_checkpoint(
            args.rationale_ckpt, enc, sched, gpt, max_chunks=max_chunks, device=device,
            generator=seeded)
        if gpt.vocab_size != vocab:
            print(f"sizing GPT-2 vocab to checkpoint: {vocab} -> {gpt.vocab_size}", flush=True)
        print(f"loaded rationale checkpoint: {report.summary()}", flush=True)
    else:
        model = RationaleModel(enc, sched, gpt, max_chunks=max_chunks, device=device,
                               generator=seeded)
    return RationaleGenerator(
        enc, sched, gpt, model, bert, HashTokenizer(vocab_size=gpt.vocab_size), feats,
        spec=spec, max_chunks=max_chunks, micro_batch=args.gen_micro_batch,
        max_rationale_len=args.max_rationale_len, device=device)


if __name__ == "__main__":
    main()
