"""Shared CLI plumbing for the PMR / VCR trainers (port of the JAX
package's ``cli/common.py``).

The flags are the JAX CLI's, with the same names and defaults (the
reference's names where it has them, run_PMR_ModCR.py:452-681), plus
``--device``: the commands run on the GPU unless it says ``cpu``.  Flags the
port does not honour yet are refused before any data is read, each with the
ROADMAP item that ports it: ``--quantize int8``, a data or model mesh over
more than one device, ``--multihost``, ``--device_features``,
``--profile_dir``, ``--tensorboard_dir`` and the HuggingFace tokenizer
directories.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
from typing import Dict, Tuple

import numpy as np

from multimodal_context_reasoning_torch.core.config import ModCRConfig, TrainConfig
from multimodal_context_reasoning_torch.data.collate import BatchSpec
from multimodal_context_reasoning_torch.data.schemas import ImageFeatures
from multimodal_context_reasoning_torch.data.tokenization import (
    HashTokenizer,
    RobertaHashTokenizer,
)


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
                   help="refused: needs transformers (ROADMAP Queue 1 item 11)")
    p.add_argument("--roberta_tokenizer_dir", type=str, default="",
                   help="refused: needs transformers (ROADMAP Queue 1 item 11)")
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
                   help="data-parallel axis size (0 = all devices); the port "
                        "runs on one device and refuses more (ROADMAP Queue 1 "
                        "item 9)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel axis size; more than 1 is refused "
                        "(ROADMAP Queue 1 item 9)")
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
                   help="W8A8 int8 inference; refused (ROADMAP Queue 1 item 6)")
    p.add_argument("--tensorboard_dir", type=str, default="",
                   help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--device_features", action="store_true",
                   help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--multihost", action="store_true",
                   help="refused (ROADMAP Queue 1 item 9)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: a CUDA device (the default; "
                        "raises without a card) or 'cpu'")
    return p


def refuse(refused) -> None:
    """SystemExit for the first ``(flag, given, ROADMAP item)`` given."""
    for flag, given, item in refused:
        if given:
            raise SystemExit(f"{flag}: the port does not honour it yet "
                             f"(ROADMAP Queue 1 item {item})")


def refuse_unported(args) -> None:
    """SystemExit for each flag the port does not honour yet, naming the
    ROADMAP item that ports it."""
    refuse([
        ("--quantize int8", args.quantize != "none", 6),
        ("--mesh_data > 1", args.mesh_data > 1, 9),
        ("--mesh_model > 1", args.mesh_model > 1, 9),
        ("--multihost", args.multihost, 9),
        ("--device_features", args.device_features, 9),
        ("--profile_dir", bool(args.profile_dir), 9),
        ("--tensorboard_dir", bool(args.tensorboard_dir), 9),
        ("--bert_tokenizer_dir", bool(args.bert_tokenizer_dir), 11),
        ("--roberta_tokenizer_dir", bool(args.roberta_tokenizer_dir), 11),
    ])


def configs_from_args(args) -> Tuple[ModCRConfig, TrainConfig]:
    refuse_unported(args)
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
    (data/subword.py, the reference's exact file formats), else the
    hermetic hash tokenizers (the serve command has no vocab-file flags, as
    in the JAX package).  A byte-BPE ``vocab.json`` given without
    ``--roberta_merges_file`` raises: read as a roberta-style WordPiece
    vocab, it would become a vocab of a few dozen ids without an error."""
    if getattr(args, "bert_vocab_file", ""):
        from multimodal_context_reasoning_torch.data.subword import WordPieceTokenizer

        bert = WordPieceTokenizer.from_vocab_file(args.bert_vocab_file)
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
