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
the "serving on" line is printed.  ``--device_features`` keeps the image
features on the device (data/device_table.py).

AOT artifacts (serving/aot.py): ``--save_artifact D`` exports the warmed
scorer to ``D`` and exits; ``--artifact D`` serves from ``D`` with no model
construction, taking the config, the micro-batch and the device from its
``artifact.json`` (so ``--eval_model_dir``, ``--params_dtype``,
``--quantize`` and ``--micro_batch`` do not apply; a ``--device`` of another
kind is refused).  ``--generate --save_gen_artifact G`` exports the warmed
greedy generator; ``--gen_artifact G`` serves ``POST /generate`` from it,
with hash tokenizers of the artifact's recorded vocabularies unless
``--bert_tokenizer_dir`` / ``--gpt_tokenizer_dir`` name HuggingFace
tokenizer directories (``transformers`` is imported only then; the GPT
tokenizer gets no ``<|det#|>`` tokens and must hold the rationale markers).
"""

from __future__ import annotations

import argparse
import json
import os
import time

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
                   help="HuggingFace tokenizer directory (needs transformers)")
    p.add_argument("--roberta_tokenizer_dir", default="",
                   help="HuggingFace tokenizer directory (needs transformers)")
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
                   help="keep the image-feature set resident on the device; "
                        "requests ship int32 row ids instead of [I, F] floats "
                        "(data/device_table.py)")
    p.add_argument("--generate", action="store_true",
                   help="also serve the rationale-generation family at "
                        "POST /generate (classify + KV-cached decode)")
    p.add_argument("--rationale_ckpt", default="",
                   help="reference ChunkAlign_CLS_dec5_4 torch checkpoint for "
                        "/generate (interop/assemble.py); random init if unset")
    p.add_argument("--gpt_tokenizer_dir", default="",
                   help="HF GPT-2 tokenizer dir for rationale decoding "
                        "(hash fallback if unset; needs transformers)")
    p.add_argument("--max_rationale_len", type=int, default=32)
    p.add_argument("--gen_micro_batch", type=int, default=4,
                   help="questions per /generate forward")
    p.add_argument("--artifact", default="",
                   help="serve from an AOT artifact directory (serving/aot.py): "
                        "no model construction; its artifact.json gives the "
                        "config, micro-batch and device")
    p.add_argument("--save_artifact", default="",
                   help="after warming the scorer, export it as an AOT "
                        "artifact to this directory and exit")
    p.add_argument("--gen_artifact", default="",
                   help="serve POST /generate from an AOT generator artifact "
                        "directory (the greedy fused program)")
    p.add_argument("--save_gen_artifact", default="",
                   help="with --generate: export the warmed generator as an "
                        "AOT artifact to this directory and exit")
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
    )
    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.core.device import resolve_device
    from multimodal_context_reasoning_torch.models.modcr import ModCRModel
    from multimodal_context_reasoning_torch.serving.scorer import ModCRScorer
    from multimodal_context_reasoning_torch.serving.server import serve
    from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager

    device = resolve_device(args.device)
    if args.artifact:
        # the AOT path: config, micro-batch and device from the artifact;
        # no model code runs
        from multimodal_context_reasoning_torch.serving.aot import AOTScorer

        meta = read_artifact_meta(args.artifact, device)
        cfg = ModCRConfig.from_json(json.dumps(meta["config"]))
        feats = load_image_features(args.img_feat_file, cfg.global_encoder.img_feature_dim)
        bert, rob = load_tokenizers(args, cfg)
        scorer = AOTScorer(args.artifact, bert, rob, feats)
        generator = load_gen_artifact(args, feats, device)
        print(f"serving AOT artifact {args.artifact} on http://{args.host}:{args.port} "
              f"(micro_batch={scorer.micro_batch}, {scorer.device}"
              f"{', /generate on' if generator else ''})", flush=True)
        serve(scorer, args.host, args.port, generator=generator,
              max_queue_batches=args.max_queue_batches, default_deadline_ms=args.deadline_ms)
        return

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
                         device=device, use_device_table=args.device_features)
    scorer.warm_up()
    if args.save_artifact:
        from multimodal_context_reasoning_torch.serving.aot import save_scorer_artifact

        t0 = time.perf_counter()
        save_scorer_artifact(args.save_artifact, scorer)
        print(f"wrote AOT artifact to {args.save_artifact} "
              f"(export {time.perf_counter() - t0:.2f} s)", flush=True)
        return
    generator = load_gen_artifact(args, feats, device)
    if generator is None and args.generate:
        generator = build_generator(args, cfg, bert, feats, device)
        if args.save_gen_artifact:
            from multimodal_context_reasoning_torch.serving.aot import save_generator_artifact

            t0 = time.perf_counter()
            save_generator_artifact(args.save_gen_artifact, generator)
            print(f"wrote AOT generator artifact to {args.save_gen_artifact} "
                  f"(export {time.perf_counter() - t0:.2f} s)", flush=True)
            return
    print(f"serving on http://{args.host}:{args.port} (micro_batch={args.micro_batch}, "
          f"{device}, {cfg.global_encoder.dtype}"
          f"{', int8' if args.quantize != 'none' else ''}"
          f"{', /generate on' if generator else ''})", flush=True)
    serve(scorer, args.host, args.port, generator=generator,
          max_queue_batches=args.max_queue_batches, default_deadline_ms=args.deadline_ms)


def read_artifact_meta(directory: str, device) -> dict:
    """An artifact's ``artifact.json``; SystemExit when it was exported for
    another kind of device than ``--device`` names."""
    with open(os.path.join(directory, "artifact.json")) as f:
        meta = json.load(f)
    if meta["device"] != device.type:
        raise SystemExit(f"{directory} was exported on {meta['device']}; "
                         f"--device {device.type} cannot serve it")
    return meta


def load_gen_artifact(args, feats, device):
    """/generate from the AOT generator artifact of ``--gen_artifact``, or
    None without one.  The tokenizers are the directories' (as the JAX
    command takes them) or hash tokenizers of the artifact's recorded
    vocabularies (the two families' vocabularies differ, and an id past a
    vocabulary fails on the card); the loader checks that the GPT tokenizer
    maps the rationale markers to the artifact's ids."""
    if not args.gen_artifact:
        return None
    from multimodal_context_reasoning_torch.data.tokenization import (
        HashTokenizer,
        hf_tokenizer_from_dir,
    )
    from multimodal_context_reasoning_torch.serving.aot import AOTGenerator

    meta = read_artifact_meta(args.gen_artifact, device)
    bert = (hf_tokenizer_from_dir(args.bert_tokenizer_dir, "--bert_tokenizer_dir")
            if args.bert_tokenizer_dir
            else HashTokenizer(vocab_size=int(meta["bert_vocab_size"])))
    return AOTGenerator(args.gen_artifact, bert, gpt_tokenizer(
        args, int(meta["gpt_vocab_size"])), feats)


def gpt_tokenizer(args, vocab_size: int):
    """``--gpt_tokenizer_dir``'s HuggingFace tokenizer (no ``<|det#|>``
    tokens: they are BERT-stream vocabulary; the rationale markers must
    already be in it, which the generator checks), else a hash tokenizer of
    ``vocab_size``."""
    from multimodal_context_reasoning_torch.data.tokenization import (
        HashTokenizer,
        hf_tokenizer_from_dir,
    )

    if args.gpt_tokenizer_dir:
        return hf_tokenizer_from_dir(args.gpt_tokenizer_dir, "--gpt_tokenizer_dir",
                                     add_det_tokens=False)
    return HashTokenizer(vocab_size=vocab_size)


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
        enc, sched, gpt, model, bert, gpt_tokenizer(args, gpt.vocab_size), feats,
        spec=spec, max_chunks=max_chunks, micro_batch=args.gen_micro_batch,
        max_rationale_len=args.max_rationale_len, device=device)


if __name__ == "__main__":
    main()
