"""The one-stage real-data recipe (port of the JAX package's
``scripts/train_real_pmr.py``): train ModCR from random init on labelled
PMR (or VCR) rows with a self-split held-out set.

The reference's end-to-end claim is its eval loop raising real validation
accuracy (run_PMR_ModCR.py:230-239).  This command splits the labelled
files (``--jsonl``, comma-separated) 80/20 after a seeded shuffle, trains
the composite from random init on the train split with the encoders frozen,
and validates held-out accuracy every ``--valid_steps`` optimizer steps.
The accuracy at random init is step 0 of the curve; the curve lands in
``<out>/curve.json`` and a summary as one JSON line on stdout.

Image features are synthesized per image id
(``serving/synthetic.py::synthetic_features``, the JAX script's arrays), so
the learnable signal is the premise/answer text through the frozen encoders
and the prefix-RoBERTa path, the trainable subgraph of the production
recipe.  ``--tokenizer corpus`` (the default) trains WordPiece vocabularies
on the train split and saves them as ``<out>/{bert,roberta}_vocab.txt``;
``hash`` uses md5 buckets.  The image features stay on the device in a
table of the compute dtype (data/device_table.py) unless
``--no_device_features``.

Three geometries: the production one (bf16, alignment off, RoBERTa remat
"full", uniform ``--dropout``, ``--roberta_dropout`` for the reasoner;
``cli/train_two_stage.py``'s stage-2 composite), ``--midsize`` (fp32,
encoders 96 wide with 6 layers, RoBERTa 128 wide with 4, text lengths that
keep short prompts and answers whole) and ``--tiny`` (fp32).  The flags and
defaults are the JAX script's, plus ``--device`` (default ``cuda``; without
a card the command raises, ``--device cpu`` asks for the CPU).
``main(argv)`` returns the :class:`Trainer`.

    python -m multimodal_context_reasoning_torch.cli.train_real_pmr \\
        --jsonl pmr_data/val-ori.jsonl --steps 600 --batch 32

    python -m multimodal_context_reasoning_torch.cli.train_real_pmr --device cpu \\
        --midsize --jsonl rows.jsonl --steps 60 --batch 8 --limit 200

The data split, the tokenizers, the feature table and the datasets are
built by functions that ``cli/train_two_stage.py`` shares.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from multimodal_context_reasoning_torch.core.config import (
    ChunkAlignConfig,
    EncoderConfig,
    ModCRConfig,
    RobertaConfig,
    TrainConfig,
)
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.data.collate import BatchSpec
from multimodal_context_reasoning_torch.data.device_table import DeviceFeatureTable
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.data.pmr import PMRDataset, load_pmr_jsonl
from multimodal_context_reasoning_torch.data.subword import corpus_wordpiece_tokenizer
from multimodal_context_reasoning_torch.data.tokenization import (
    NUM_DET_TOKENS,
    HashTokenizer,
    RobertaHashTokenizer,
)
from multimodal_context_reasoning_torch.data.vcr import VCRDataset, load_vcr_json
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.serving.synthetic import synthetic_features
from multimodal_context_reasoning_torch.train.trainer import Trainer

LOADERS = {"pmr": (load_pmr_jsonl, PMRDataset), "vcr": (load_vcr_json, VCRDataset)}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="pmr", choices=["pmr", "vcr"],
                   help="vcr: line-delimited vcr_val.json through the VCR featurizer "
                        "(the RoBERTa body stays trainable: random init has no "
                        "pretrained body to protect)")
    p.add_argument("--jsonl", default="pmr_data/val-ori.jsonl",
                   help="labelled task data files, comma-separated (val-ori and "
                        "test-ori are both labelled)")
    p.add_argument("--train_frac", type=float, default=0.8)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--eval_batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--warmup", type=int, default=50)
    p.add_argument("--valid_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=0, help="cap the examples of each file")
    p.add_argument("--tokenizer", choices=["corpus", "hash"], default="corpus",
                   help="'corpus': a WordPiece vocabulary trained on the train split "
                        "(data/subword.py); 'hash': md5 buckets (collisions alias words)")
    p.add_argument("--vocab_budget", type=int, default=8192,
                   help="corpus vocabulary size before the det tokens")
    p.add_argument("--tiny", action="store_true", help="the tiny test geometry")
    p.add_argument("--midsize", action="store_true",
                   help="a reduced geometry whose text lengths keep the prompt and "
                        "answers whole (the tiny one's 16/20 tokens truncate them)")
    p.add_argument("--roberta_dropout", type=float, default=None,
                   help="the reasoner's dropout (default: --dropout)")
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--dropout", type=float, default=0.1,
                   help="uniform dropout of every site (the reference's 0.3 encoder / "
                        "0.1 reasoner stack is tuned for pretrained towers)")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "pmr_real"))
    p.add_argument("--no_device_features", dest="device_features", action="store_false",
                   default=True,
                   help="ship each batch's region features from the host instead of "
                        "gathering them from a device-resident table")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a card) or cpu")
    return p


def composite_config(args) -> ModCRConfig:
    """The production training geometry (bf16, alignment off: the reference
    trainer never optimizes the alignment maps, run_PMR_ModCR.py:204-208;
    RoBERTa remat "full"; uniform ``args.dropout``, ``args.roberta_dropout``
    for the reasoner), or under ``args.tiny`` the tiny one with alignment
    off.  The two-stage recipe's stage 2 trains it and its stage 1 reuses
    its encoder geometry, so the graft lands key for key."""
    if args.tiny:
        return dataclasses.replace(ModCRConfig.tiny(), compute_alignment=False)
    cfg = ModCRConfig(compute_alignment=False).with_dtype("bfloat16")
    d = args.dropout
    enc = dataclasses.replace(cfg.global_encoder, hidden_dropout_prob=d,
                              attention_probs_dropout_prob=d)
    rd = d if args.roberta_dropout is None else args.roberta_dropout
    rob = dataclasses.replace(cfg.roberta, remat=True, hidden_dropout_prob=rd,
                              attention_probs_dropout_prob=rd)
    return dataclasses.replace(cfg, global_encoder=enc, seq_encoder=enc, roberta=rob,
                               mapping_dropout=d)


def model_config(args) -> ModCRConfig:
    """``--tiny``, then ``--midsize`` (fp32: encoders 96 wide, 6 layers, 8
    heads of 12; RoBERTa 128 wide, 4 layers, 8 heads of 16; every dropout
    ``--dropout``), else the production geometry."""
    if args.tiny or not args.midsize:
        return composite_config(args)
    d = args.dropout
    enc = EncoderConfig(vocab_size=4096, hidden_size=96, num_hidden_layers=6,
                        num_attention_heads=8, intermediate_size=192,
                        hidden_dropout_prob=d, attention_probs_dropout_prob=d,
                        img_feature_dim=64)
    rob = RobertaConfig(vocab_size=4096, hidden_size=128, num_hidden_layers=4,
                        num_attention_heads=8, intermediate_size=256,
                        hidden_dropout_prob=d, attention_probs_dropout_prob=d)
    return ModCRConfig(global_encoder=enc, seq_encoder=enc, roberta=rob,
                       chunkalign=ChunkAlignConfig(chunk_layers_end=1, full_layers_end=3),
                       text_len=48, img_len=10, roberta_len=72, max_chunks=22,
                       mapping_dropout=d, compute_alignment=False)


def load_examples(task: str, jsonl: str, limit: int) -> list:
    """Every example of the comma-separated files, at most ``limit`` (0: no
    cap) from each."""
    load_fn = LOADERS[task][0]
    examples = []
    for path in jsonl.split(","):
        examples.extend(load_fn(path, limit=limit or None))
    return examples


def split_examples(examples: list, seed: int, train_frac: float) -> Tuple[list, list]:
    """(train, held-out): the first ``train_frac`` of a seeded permutation."""
    order = np.random.default_rng(seed).permutation(len(examples))
    n_train = int(len(examples) * train_frac)
    return [examples[i] for i in order[:n_train]], [examples[i] for i in order[n_train:]]


def build_tokenizers(kind: str, corpus_ex: List, cfg: ModCRConfig, vocab_budget: int,
                     out: str, logger: logging.Logger):
    """(BERT, RoBERTa) tokenizers.  ``corpus``: WordPiece trained on the
    premises and answers of ``corpus_ex``, each within its tower's
    vocabulary, saved as ``<out>/{bert,roberta}_vocab.txt`` (checkpoints
    are servable only with these ids); ``hash``: md5 buckets."""
    if kind != "corpus":
        return (HashTokenizer(vocab_size=cfg.seq_encoder.vocab_size),
                RobertaHashTokenizer(vocab_size=cfg.roberta.vocab_size))
    corpus = ([ex.premise for ex in corpus_ex]
              + [a for ex in corpus_ex for a in ex.answer_choices])
    t0 = time.time()
    bert = corpus_wordpiece_tokenizer(
        corpus, vocab_size=min(vocab_budget, cfg.seq_encoder.vocab_size - NUM_DET_TOKENS))
    rob = corpus_wordpiece_tokenizer(
        corpus, vocab_size=min(vocab_budget, cfg.roberta.vocab_size - NUM_DET_TOKENS),
        style="roberta")
    logger.info("corpus WordPiece trained: %d/%d ids (bert/roberta), %.1f s",
                len(bert), len(rob), time.time() - t0)
    assert len(bert) <= cfg.seq_encoder.vocab_size and len(rob) <= cfg.roberta.vocab_size
    os.makedirs(out, exist_ok=True)
    bert.save_vocab_file(os.path.join(out, "bert_vocab.txt"))
    rob.save_vocab_file(os.path.join(out, "roberta_vocab.txt"))
    return bert, rob


def feature_table(feats, img_len: int, dtype: str, device: torch.device,
                  logger: logging.Logger) -> DeviceFeatureTable:
    """The image features resident on ``device`` in ``dtype``."""
    table = DeviceFeatureTable(feats, img_len=img_len, dtype=dtype, device=device)
    logger.info("device feature table resident: %d images, %.1f MB (%s)",
                len(table.row), table.nbytes / 1e6, dtype)
    return table


def make_dataset(dataset_cls, exs: list, feats, bert, rob, cfg: ModCRConfig,
                 table: Optional[DeviceFeatureTable]):
    """``exs`` featurized at ``cfg``'s lengths; with ``table``, its batches
    carry row ids into it instead of the features."""
    spec = BatchSpec(text_len=cfg.text_len, img_len=cfg.img_len,
                     roberta_len=cfg.roberta_len, num_labels=cfg.num_labels,
                     img_feature_dim=cfg.seq_encoder.img_feature_dim)
    ds = dataset_cls(exs, feats, bert, rob, spec=spec, max_chunks=cfg.max_chunks)
    if table is not None:
        ds.use_device_table(table)
    return ds


def main(argv=None) -> Trainer:
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        stream=sys.stderr, force=True)
    logger = logging.getLogger("pmr-real")

    cfg = model_config(args)
    examples = load_examples(args.task, args.jsonl, args.limit)
    train_ex, val_ex = split_examples(examples, args.seed, args.train_frac)
    logger.info("examples: %d train / %d held-out", len(train_ex), len(val_ex))

    feats = synthetic_features({ex.img_id for ex in examples},
                               cfg.global_encoder.img_feature_dim,
                               max_regions=min(cfg.img_len, 20))
    bert, rob = build_tokenizers(args.tokenizer, train_ex, cfg, args.vocab_budget, args.out,
                                 logger)
    # the table keeps the compute dtype: a bf16 table under fp32 compute
    # would round the features
    table = (feature_table(feats, cfg.img_len, cfg.global_encoder.dtype, device, logger)
             if args.device_features else None)
    dataset_cls = LOADERS[args.task][1]
    train_dl = DataLoader(make_dataset(dataset_cls, train_ex, feats, bert, rob, cfg, table),
                          args.batch, shuffle=True, seed=args.seed, drop_last=True)
    if len(train_dl) == 0:
        # the JAX script stops here too (its init draws a sample batch from
        # the empty loader); unlike the two-stage recipe, no batch clamp
        raise ValueError(f"{len(train_ex)} train examples fill no batch of --batch "
                         f"{args.batch}")
    val_dl = DataLoader(make_dataset(dataset_cls, val_ex, feats, bert, rob, cfg, table),
                        args.eval_batch)

    tcfg = TrainConfig(
        learning_rate=args.lr, weight_decay=args.weight_decay, warmup_steps=args.warmup,
        max_steps=args.steps, num_train_epochs=10_000, per_device_batch_size=args.batch,
        valid_steps=args.valid_steps, epoch_begin=1, seed=args.seed,
        compute_dtype="float32" if (args.tiny or args.midsize) else "bfloat16")
    t0 = time.time()
    model = ModCRModel(cfg, device=device,
                       generator=torch.Generator(device=device).manual_seed(args.seed))
    os.makedirs(args.out, exist_ok=True)
    trainer = Trainer(model, tcfg, train_dl, val_dl, logger=logger, device=device)
    state = trainer.init_state()
    logger.info("init done in %.1fs on %s", time.time() - t0, device.type)

    base_acc = trainer.evaluate()
    logger.info("held-out accuracy at random init: %.4f (chance=0.25)", base_acc)
    trainer.history.append({"epoch": 0, "step": 0, "val_acc": base_acc,
                            "train_loss": None, "train_acc": None})

    t0 = time.time()
    trainer.fit(state)
    wall = time.time() - t0
    final_acc = trainer.evaluate()

    curve = {
        "task": args.task,
        "data": ",".join(os.path.basename(p) for p in args.jsonl.split(",")),
        "n_train": len(train_ex), "n_val": len(val_ex),
        "steps": args.steps, "batch": args.batch, "lr": args.lr,
        "seed": args.seed, "tiny": args.tiny,
        "wall_seconds": round(wall, 1),
        "baseline_acc": base_acc,
        "final_acc": final_acc,
        "best_acc": trainer.best_acc,
        "history": trainer.history,
    }
    path = os.path.join(args.out, "curve.json")
    with open(path, "w") as f:
        json.dump(curve, f, indent=1)
    logger.info("wrote %s", path)
    print(json.dumps({
        "baseline_acc": round(base_acc, 4),
        "best_acc": round(trainer.best_acc, 4),
        "final_acc": round(final_acc, 4),
        "steps": args.steps, "wall_seconds": round(wall, 1),
    }))
    return trainer


if __name__ == "__main__":
    main()
