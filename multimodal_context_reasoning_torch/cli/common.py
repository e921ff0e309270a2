"""Shared CLI plumbing for the PMR / VCR trainers (port of the JAX
package's ``cli/common.py``).

The flags are the JAX CLI's, with the same names and defaults (the
reference's names where it has them, run_PMR_ModCR.py:452-681), plus
``--device``: the commands run on the GPU unless it says ``cpu``.
``--multihost`` joins the process group that ``torchrun`` describes in the
environment (NCCL on the card, gloo on the CPU), and ``--mesh_data`` /
``--mesh_model`` shape the ("data", "model") mesh over it
(:func:`mesh_from_args`, parallel/); a mesh over more than one process
without a process group is a ``SystemExit``, never one process.
``--bert_tokenizer_dir`` / ``--roberta_tokenizer_dir`` load HuggingFace
tokenizers from local directories (``transformers`` is imported only
then).  ``--device_features`` keeps
the image-feature set on the card (data/device_table.py), ``--profile_dir``
writes a ``torch.profiler`` trace of a few train steps and
``--tensorboard_dir`` the training scalars (train/trainer.py).
``--quantize int8`` is inference-only and refused under ``--do_train``, with
the JAX CLI's wording.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_context_reasoning_torch.core.config import ModCRConfig, TrainConfig
from multimodal_context_reasoning_torch.data.collate import BatchSpec
from multimodal_context_reasoning_torch.data.schemas import ImageFeatures
from multimodal_context_reasoning_torch.data.tokenization import (
    HashTokenizer,
    RobertaHashTokenizer,
    hf_tokenizer_from_dir,
)
from multimodal_context_reasoning_torch.parallel.mesh import make_mesh, mesh_shape_for


def build_arg_parser(task: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"ModCR {task} trainer (PyTorch/CUDA port)")
    # reference flag names (run_PMR_ModCR.py:452-681) where applicable
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_test", action="store_true")
    p.add_argument("--output_dir", type=str, default=f"output/{task}")
    p.add_argument("--eval_model_dir", type=str, default="")
    p.add_argument("--per_gpu_train_batch_size", type=int, default=16)
    p.add_argument("--per_gpu_eval_batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--adam_epsilon", type=float, default=1e-5)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--scheduler", type=str, default="linear",
                   choices=("linear", "constant"))
    p.add_argument("--num_train_epochs", type=int, default=30)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--seed", type=int, default=88)
    p.add_argument("--valid_steps", type=int, default=400)
    p.add_argument("--epoch_begin", type=int, default=2)
    p.add_argument("--max_seq_length", type=int, default=140)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    # data locations (the reference hardcodes relative paths; we take flags)
    p.add_argument("--train_file", type=str, default="")
    p.add_argument("--val_file", type=str, default="")
    p.add_argument("--test_file", type=str, default="")
    p.add_argument("--img_feat_file", type=str, default="",
                   help="pickle: {img-id: {'features': [N,2054], ...}}, "
                        "or an .mcrpack (data/feature_store.py)")
    p.add_argument("--bert_tokenizer_dir", type=str, default="",
                   help="HuggingFace tokenizer directory for the BERT towers "
                        "(needs transformers)")
    p.add_argument("--roberta_tokenizer_dir", type=str, default="",
                   help="HuggingFace tokenizer directory for RoBERTa "
                        "(needs transformers)")
    # in-tree subword loaders (data/subword.py): the reference's file formats
    p.add_argument("--bert_vocab_file", type=str, default="",
                   help="WordPiece vocab.txt → in-tree WordPieceTokenizer")
    p.add_argument("--roberta_vocab_file", type=str, default="",
                   help="byte-BPE vocab.json → in-tree ByteBPETokenizer "
                        "(with --roberta_merges_file), or a corpus-trained "
                        "roberta-style WordPiece vocab.txt (without)")
    p.add_argument("--roberta_merges_file", type=str, default="")
    # reference-checkpoint import (interop/assemble.py; any may be omitted)
    p.add_argument("--oscar_ckpt", type=str, default="",
                   help="Oscar-base BertImgModel torch weights (.bin/.pth)")
    p.add_argument("--chunkalign_ckpt", type=str, default="",
                   help="ChunkAlign pretrain dict (seq_enc.-prefixed)")
    p.add_argument("--roberta_ckpt", type=str, default="",
                   help="roberta-large torch weights")
    p.add_argument("--modcr_ckpt", "--reference_ckpt", type=str, default="",
                   help="reference ModCR checkpoint ({'net': ...} form, the "
                        "published best.pth layout, run_PMR_ModCR.py:802-806;"
                        " --reference_ckpt is an alias)")
    p.add_argument("--cold_start", action="store_true",
                   help="stage-1 surgery: drop mapping-network/classifier "
                        "keys of --modcr_ckpt (run_PMR_ModCR.py:819-832)")
    p.add_argument("--num_labels", type=int, default=0,
                   help="candidate count override (run_PMR_ModCR.py:608; "
                        "0 = task default: PMR/VCR use 4)")
    p.add_argument("--img_feature_dim", type=int, default=0,
                   help="region-feature width override "
                        "(run_PMR_ModCR.py:588; 0 = default 2054)")
    p.add_argument("--drop_out", type=float, default=-1.0,
                   help="encoder-tower dropout override "
                        "(run_PMR_ModCR.py:585,719,738; <0 = config "
                        "default 0.3)")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel axis size (0 = every process of the "
                        "group over --mesh_model)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel (tensor-parallel) axis size")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=("float32", "bfloat16"))
    p.add_argument("--limit", type=int, default=0,
                   help="cap the number of examples (debug)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config for smoke tests / CI")
    p.add_argument("--skip_alignment_loss", action="store_true",
                   help="drop the (never-optimized) CALeC alignment loss "
                        "from the train graph")
    p.add_argument("--remat", action="store_true",
                   help="recompute the RoBERTa tower's layers in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--remat_policy", type=str, default="dots",
                   choices=["full", "dots"],
                   help="with --remat: 'dots' keeps matmul outputs and "
                        "recomputes only elementwise work; 'full' "
                        "recomputes everything")
    p.add_argument("--flash_attention", action="store_true",
                   help="kept for the JAX CLI's config round trip: the port "
                        "takes the same attention path either way")
    p.add_argument("--scan_layers", action="store_true",
                   help="one stacked-layer branch of the RoBERTa tower, as "
                        "the JAX package's lax.scan; the parameter keys stay "
                        "per layer")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8"],
                   help="W8A8 int8 inference (ops/quant.py); refused under "
                        "--do_train")
    p.add_argument("--tensorboard_dir", type=str, default="",
                   help="write the training scalars here (SummaryWriter, or "
                        "metrics.jsonl without the tensorboard package)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of a few train "
                        "steps here (from micro-step 10; 2 with --tiny)")
    p.add_argument("--device_features", action="store_true",
                   help="keep the image-feature set resident on the device; "
                        "batches ship int32 row ids instead of [I, F] floats "
                        "(data/device_table.py)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed process group torchrun "
                        "describes (env://): NCCL with a CUDA --device, gloo "
                        "on the CPU; each process takes cuda:LOCAL_RANK")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: a CUDA device (the default; "
                        "raises without a card) or 'cpu'")
    return p


def maybe_init_distributed(args) -> None:
    """``--multihost``: join the process group ``torchrun`` sets up in the
    environment (``env://``), NCCL for a CUDA ``--device`` and gloo for the
    CPU; on the card each process takes ``cuda:LOCAL_RANK``."""
    if not getattr(args, "multihost", False) or dist.is_initialized():
        return
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")


def mesh_from_args(args):
    """The ("data", "model") mesh of ``--mesh_data`` / ``--mesh_model`` over
    the process group, or None for one process without one.  A mesh of more
    than one process without a process group, or one that does not cover
    the group, is a ``SystemExit``; so is a batch size that the data axis
    does not divide (every batch axis splits over it)."""
    n_model = max(args.mesh_model, 1)
    if not dist.is_initialized():
        n_data = args.mesh_data or 1
        if n_data * n_model > 1:
            raise SystemExit(
                f"--mesh_data {n_data} --mesh_model {n_model}: a mesh over more than one "
                "process needs a torch.distributed process group; launch with torchrun "
                "and pass --multihost")
        return None
    try:
        shape = ((args.mesh_data, n_model) if args.mesh_data
                 else mesh_shape_for(dist.get_world_size(), n_model))
        mesh = make_mesh(shape)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    n_data = shape[0]
    for flag, val in (("per_gpu_train_batch_size", args.per_gpu_train_batch_size),
                      ("per_gpu_eval_batch_size", args.per_gpu_eval_batch_size)):
        if val % n_data:
            raise SystemExit(
                f"--{flag}={val} must be divisible by the data-mesh "
                f"size {n_data} (pass --mesh_data to shrink the mesh)"
            )
    return mesh


def configs_from_args(args) -> Tuple[ModCRConfig, TrainConfig]:
    if args.tiny:
        cfg = ModCRConfig.tiny()
    else:
        cfg = ModCRConfig(
            text_len=min(args.max_seq_length, 140),
            img_len=args.max_img_seq_length,
        ).with_dtype(args.compute_dtype)
    if args.num_labels:
        cfg = dataclasses.replace(cfg, num_labels=args.num_labels)
    if args.img_feature_dim:
        cfg = dataclasses.replace(
            cfg,
            global_encoder=dataclasses.replace(
                cfg.global_encoder, img_feature_dim=args.img_feature_dim),
            seq_encoder=dataclasses.replace(
                cfg.seq_encoder, img_feature_dim=args.img_feature_dim),
        )
    if args.drop_out >= 0:
        # the reference applies --drop_out to BOTH Oscar towers' configs
        # (run_PMR_ModCR.py:719,738); RoBERTa keeps its own 0.1
        cfg = dataclasses.replace(
            cfg,
            global_encoder=dataclasses.replace(
                cfg.global_encoder, hidden_dropout_prob=args.drop_out),
            seq_encoder=dataclasses.replace(
                cfg.seq_encoder, hidden_dropout_prob=args.drop_out),
        )
    if args.skip_alignment_loss:
        cfg = dataclasses.replace(cfg, compute_alignment=False)
    if args.quantize != "none":
        if args.do_train:
            raise SystemExit(
                "--quantize is inference-only (round() has zero gradient); "
                "drop it for --do_train"
            )
        cfg = cfg.with_quantize(args.quantize)
    if args.remat:
        cfg = dataclasses.replace(
            cfg, roberta=dataclasses.replace(
                cfg.roberta, remat=True, remat_policy=args.remat_policy))
    if args.flash_attention:
        cfg = dataclasses.replace(
            cfg, roberta=dataclasses.replace(cfg.roberta, mem_efficient_attention=True))
    if args.scan_layers:
        cfg = dataclasses.replace(
            cfg, roberta=dataclasses.replace(cfg.roberta, scan_layers=True))
    tcfg = TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        warmup_steps=args.warmup_steps,
        scheduler=args.scheduler,
        num_train_epochs=args.num_train_epochs,
        max_steps=args.max_steps,
        per_device_batch_size=args.per_gpu_train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        seed=args.seed,
        valid_steps=args.valid_steps,
        epoch_begin=args.epoch_begin,
        compute_dtype=args.compute_dtype,
    )
    return cfg, tcfg


def _is_json_vocab(path: str) -> bool:
    """True for a byte-BPE ``vocab.json`` (a JSON object), not a one token
    per line ``vocab.txt``."""
    with open(path, encoding="utf-8") as f:
        try:
            return isinstance(json.load(f), dict)
        except json.JSONDecodeError:
            return False


def load_tokenizers(args, cfg: ModCRConfig):
    """Tokenizer per tower: the in-tree subword loaders from vocab files
    (data/subword.py, the reference's exact file formats), else a
    HuggingFace tokenizer directory, else the hermetic hash tokenizers (the
    serve command has no vocab-file flags, as in the JAX package).  A byte-BPE ``vocab.json`` given without
    ``--roberta_merges_file`` raises: read as a roberta-style WordPiece
    vocab, it would become a vocab of a few dozen ids without an error."""
    if getattr(args, "bert_vocab_file", ""):
        from multimodal_context_reasoning_torch.data.subword import WordPieceTokenizer

        bert = WordPieceTokenizer.from_vocab_file(args.bert_vocab_file)
    elif args.bert_tokenizer_dir:
        bert = hf_tokenizer_from_dir(args.bert_tokenizer_dir, "--bert_tokenizer_dir")
    else:
        bert = HashTokenizer(vocab_size=cfg.global_encoder.vocab_size)
    if getattr(args, "roberta_vocab_file", ""):
        from multimodal_context_reasoning_torch.data.subword import (
            ByteBPETokenizer,
            WordPieceTokenizer,
        )

        if args.roberta_merges_file:
            rob = ByteBPETokenizer.from_files(
                args.roberta_vocab_file, args.roberta_merges_file)
        elif _is_json_vocab(args.roberta_vocab_file):
            raise ValueError(
                f"{args.roberta_vocab_file} is a byte-BPE vocab.json: pass its "
                "merges.txt as --roberta_merges_file")
        else:
            # merges-less = a corpus-trained roberta-style WordPiece vocab
            rob = WordPieceTokenizer.from_roberta_style_vocab_file(
                args.roberta_vocab_file)
    elif args.roberta_tokenizer_dir:
        rob = hf_tokenizer_from_dir(args.roberta_tokenizer_dir, "--roberta_tokenizer_dir")
    else:
        rob = RobertaHashTokenizer(vocab_size=cfg.roberta.vocab_size)
    for tok, limit, tower in (
        (bert, cfg.global_encoder.vocab_size, "bert"),
        (rob, cfg.roberta.vocab_size, "roberta"),
    ):
        n = len(tok)
        if n > limit:
            # ids >= vocab_size would index past the embedding table
            raise ValueError(
                f"{tower} tokenizer emits {n} ids but the model vocab is "
                f"{limit}; grow the config vocab or shrink the vocab file")
    return bert, rob


def load_image_features(path: str, img_feature_dim: int):
    """Image-feature source:

    - ``*.mcrpack`` — the indexed mmap store (data/feature_store.py);
    - otherwise a reference-format pickle: {img-id: {'features': [N, 2054],
      'img_mask': ...}} (Data/VCRChunkAlign.py:586-592, 806-812), loaded
      whole into RAM like the reference does.
    """
    if path.endswith(".mcrpack"):
        from multimodal_context_reasoning_torch.data.feature_store import FeatureStore

        fs = FeatureStore(path)
        if fs.dim != img_feature_dim:
            raise ValueError(
                f"{path}: feature dim {fs.dim} != expected {img_feature_dim}"
            )
        return fs

    out: Dict[str, ImageFeatures] = {}
    with open(path, "rb") as f:
        raw = pickle.load(f)
    for key, val in raw.items():
        feats = val["features"] if isinstance(val, dict) else val
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != img_feature_dim:
            raise ValueError(f"{key}: bad feature shape {feats.shape}")
        out[str(key)] = ImageFeatures(features=feats, num_regions=feats.shape[0])
    return out


def batch_spec(cfg: ModCRConfig) -> BatchSpec:
    return BatchSpec(
        text_len=cfg.text_len, img_len=cfg.img_len,
        roberta_len=cfg.roberta_len, num_labels=cfg.num_labels,
        img_feature_dim=cfg.global_encoder.img_feature_dim,
    )


def write_test_predictions(path: str, examples, logits: np.ndarray) -> None:
    """Reference test() output: one JSON line per example with
    {total_id, img_id, prediction, answer_type} (run_PMR_ModCR.py:332-351)."""
    preds = np.argmax(logits, axis=-1)
    with open(path, "w") as f:
        for ex, pred in zip(examples, preds):
            atype = None
            if ex.answer_types:
                atype = ex.answer_types[int(pred)]
            f.write(json.dumps({
                "total_id": ex.example_id,
                "img_id": ex.img_id,
                "prediction": int(pred),
                "answer_type": atype,
            }) + "\n")
