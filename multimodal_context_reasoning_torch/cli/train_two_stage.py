"""The two-stage recipe, the reference's own training shape (port of the JAX
package's ``scripts/train_two_stage.py``).

The reference never trains ModCR in one stage: its composite loads a
ChunkAlign-pretrain checkpoint whose towers were trained first under the
``ChunkAlign_CLS_enc4_align`` regime (modeling_vcr_chunkalign_v10.py:
1016-1165), then prefix-tunes with both towers frozen.

Stage 1, ChunkAlign pretrain: :class:`ChunkAlignClassifier` (both towers
trainable, binary CE plus the attention-alignment CE) trains under
``Trainer`` with best-accuracy checkpoints of the parameters alone; the best
step is restored and exported in the reference's checkpoint layout
(interop/export.py) to ``<out>/chunkalign_cls_state_dict.npz``.

Stage 2, cold-start surgery and prefix-tune: a fresh composite grafts
``seq_enc`` through the reference's ``seq_enc.``-strip path
(``assemble_modcr_params(chunkalign_sd=...)``, run_PMR_ModCR.py:752-763) and
the global tower through the ``oscar_sd`` path, is evaluated, then trains the
production recipe (frozen towers, mapping networks and prefix-RoBERTa live).

Both stages share the featurized datasets; image features are synthesized
per image id (``serving/synthetic.py::synthetic_features``, the JAX script's
arrays).  The flags and defaults are the JAX script's, plus ``--device``
(default ``cuda``; without a card the command raises, ``--device cpu`` asks
for the CPU).  The image features stay on the device in a resident table
(data/device_table.py) unless ``--no_device_features`` sends them through
the host loader, which changes where they live, not the numbers: the table
is fp32 when either stage computes in fp32, bf16 otherwise, and the forward
casts the features to its compute dtype either way.  ``main(argv)`` writes ``<out>/curve.json``, prints one JSON line and returns
the curve.

    python -m multimodal_context_reasoning_torch.cli.train_two_stage \\
        --jsonl pmr_data/val-ori.jsonl --stage1_steps 400 --stage2_steps 600

    python -m multimodal_context_reasoning_torch.cli.train_two_stage --device cpu \\
        --tiny --jsonl rows.jsonl --stage1_steps 20 --stage2_steps 20 --batch 4 \\
        --stage1_batch 4 --limit 80
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np
import torch

from multimodal_context_reasoning_torch.core.config import ModCRConfig, TrainConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.data.collate import BatchSpec
from multimodal_context_reasoning_torch.data.device_table import DeviceFeatureTable
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.data.mixed import MixedDataset
from multimodal_context_reasoning_torch.data.pmr import PMRDataset, load_pmr_jsonl
from multimodal_context_reasoning_torch.data.subword import corpus_wordpiece_tokenizer
from multimodal_context_reasoning_torch.data.tokenization import (
    NUM_DET_TOKENS,
    HashTokenizer,
    RobertaHashTokenizer,
)
from multimodal_context_reasoning_torch.data.vcr import VCRDataset, load_vcr_json
from multimodal_context_reasoning_torch.interop.assemble import assemble_modcr_params
from multimodal_context_reasoning_torch.interop.export import export_chunkalign_cls_state_dict
from multimodal_context_reasoning_torch.models.chunkalign_cls import ChunkAlignClassifier
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.serving.synthetic import synthetic_features
from multimodal_context_reasoning_torch.train.trainer import Trainer

LOADERS = {"pmr": (load_pmr_jsonl, PMRDataset), "vcr": (load_vcr_json, VCRDataset)}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="pmr", choices=["pmr", "vcr"])
    p.add_argument("--jsonl", default="pmr_data/val-ori.jsonl",
                   help="task data files, comma-separated")
    p.add_argument("--train_frac", type=float, default=0.8)
    p.add_argument("--stage1_steps", type=int, default=400)
    p.add_argument("--stage2_steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=32,
                   help="stage-2 batch (questions; x4 candidate rows)")
    p.add_argument("--stage1_batch", type=int, default=16,
                   help="stage-1 batch: the towers carry gradients, so the activations "
                        "take about 4x the frozen-tower composite's at equal batch")
    p.add_argument("--eval_batch", type=int, default=32)
    p.add_argument("--lr1", type=float, default=3e-5)
    p.add_argument("--lr2", type=float, default=3e-5)
    p.add_argument("--align_weight", type=float, default=1.0,
                   help="stage-1 align-CE weight (the reference returns the two losses "
                        "apart, v10.py:1084)")
    p.add_argument("--seq_lr_scale", type=float, default=1.0,
                   help="stage-1 lr scale of the seq_enc group (the reference's x0.1 "
                        "protects a pretrained tower; from scratch both need the full lr)")
    p.add_argument("--warmup", type=int, default=50)
    p.add_argument("--valid_steps", type=int, default=50)
    p.add_argument("--stage1_valid_steps", type=int, default=None,
                   help="stage-1 validation cadence (default: --valid_steps)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--tokenizer", choices=["corpus", "hash"], default="corpus",
                   help="'corpus': a WordPiece vocabulary trained on the task text "
                        "(data/subword.py); 'hash': md5 buckets")
    p.add_argument("--vocab_budget", type=int, default=8192)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--dropout", type=float, default=0.1, help="uniform dropout")
    p.add_argument("--roberta_dropout", type=float, default=None)
    p.add_argument("--stage1_compute", default=None, choices=["float32", "bfloat16"],
                   help="stage-1 compute dtype (default: bf16 at full size, fp32 under "
                        "--tiny)")
    p.add_argument("--stage1_dropout", type=float, default=None,
                   help="the encoders' dropout in stage 1 only")
    p.add_argument("--stage1_npz", default=None,
                   help="skip stage 1: graft from an existing chunkalign_cls_state_dict.npz")
    p.add_argument("--stage1_task", default=None, choices=["pmr", "vcr", "both"],
                   help="pretrain stage 1 on another task's data (default: --task); "
                        "'both' mixes tasks (data/mixed.py) from pmr:/vcr:-prefixed "
                        "--stage1_jsonl entries")
    p.add_argument("--stage1_jsonl", default=None,
                   help="stage-1 data files (default: --jsonl); entries may carry a "
                        "pmr:/vcr: prefix.  Splits reuse the stage-2 seed and fraction")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "two_stage"))
    p.add_argument("--no_device_features", dest="device_features", action="store_false",
                   default=True)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a card) or cpu")
    return p


def composite_config(args) -> ModCRConfig:
    """The stage-2 composite's config; stage 1 reuses its encoder geometry
    so the graft lands key for key."""
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


def split_entry(entry: str, default_task: str):
    """``pmr:path`` / ``vcr:path`` -> (task, path); a bare path -> ``default_task``."""
    head, _, rest = entry.partition(":")
    if head in LOADERS and rest:
        return head, rest
    return default_task, entry


def main(argv=None) -> dict:
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        stream=sys.stderr, force=True)
    logger = logging.getLogger("two-stage")

    cfg2 = composite_config(args)
    enc_cfg = cfg2.seq_encoder
    # an fp32 stage keeps an fp32 table (a bf16 one would round its
    # features); under bf16 compute the forward's cast rounds fp32 rows
    # exactly as a bf16 table would
    s1_dtype = args.stage1_compute or ("float32" if args.tiny else "bfloat16")
    table_dtype = ("float32" if "float32" in (s1_dtype, cfg2.global_encoder.dtype)
                   else "bfloat16")

    def make_table(f):
        if not args.device_features:
            return None
        table = DeviceFeatureTable(f, img_len=cfg2.img_len, dtype=table_dtype,
                                   device=device)
        logger.info("device feature table resident: %d images, %.1f MB (%s)",
                    len(table.row), table.nbytes / 1e6, table_dtype)
        return table

    # ---- shared data (both stages featurize identically)
    load_fn, dataset_cls = LOADERS[args.task]
    examples = []
    for path in args.jsonl.split(","):
        examples.extend(load_fn(path, limit=args.limit or None))
    order = np.random.default_rng(args.seed).permutation(len(examples))
    n_train = int(len(examples) * args.train_frac)
    train_ex = [examples[i] for i in order[:n_train]]
    val_ex = [examples[i] for i in order[n_train:]]
    logger.info("examples: %d train / %d held-out", len(train_ex), len(val_ex))
    if len(train_ex) < max(args.batch, args.stage1_batch):
        # drop_last would otherwise leave an empty training loader
        clamped = max(1, len(train_ex))
        logger.warning("clamping batch sizes %d/%d -> %d (only %d train examples)",
                       args.stage1_batch, args.batch, clamped, len(train_ex))
        args.stage1_batch = min(args.stage1_batch, clamped)
        args.batch = min(args.batch, clamped)

    max_regions = min(cfg2.img_len, 20)
    feats = synthetic_features({ex.img_id for ex in examples}, enc_cfg.img_feature_dim,
                               max_regions=max_regions)
    os.makedirs(args.out, exist_ok=True)
    if args.tokenizer == "corpus":
        # one collision-free id space for both stages: the stage-2 train
        # split plus any cross-task stage-1 text
        corpus_ex = list(train_ex)
        if args.stage1_jsonl:
            for entry in args.stage1_jsonl.split(","):
                task, path = split_entry(entry, args.stage1_task or args.task)
                load1 = LOADERS["vcr" if task == "vcr" else "pmr"][0]
                corpus_ex.extend(load1(path, limit=args.limit or None))
        corpus = ([ex.premise for ex in corpus_ex]
                  + [a for ex in corpus_ex for a in ex.answer_choices])
        bert = corpus_wordpiece_tokenizer(
            corpus, vocab_size=min(args.vocab_budget, enc_cfg.vocab_size - NUM_DET_TOKENS))
        rob_tok = corpus_wordpiece_tokenizer(
            corpus, vocab_size=min(args.vocab_budget,
                                   cfg2.roberta.vocab_size - NUM_DET_TOKENS),
            style="roberta")
        logger.info("corpus WordPiece trained: %d/%d ids (bert/roberta)",
                    len(bert), len(rob_tok))
        # checkpoints are servable only with these ids
        bert.save_vocab_file(os.path.join(args.out, "bert_vocab.txt"))
        rob_tok.save_vocab_file(os.path.join(args.out, "roberta_vocab.txt"))
    else:
        bert = HashTokenizer(vocab_size=enc_cfg.vocab_size)
        rob_tok = RobertaHashTokenizer(vocab_size=cfg2.roberta.vocab_size)
    spec = BatchSpec(text_len=cfg2.text_len, img_len=cfg2.img_len,
                     roberta_len=cfg2.roberta_len, num_labels=cfg2.num_labels,
                     img_feature_dim=enc_cfg.img_feature_dim)

    def mk_ds(ds_cls, f, table, exs):
        ds = ds_cls(exs, f, bert, rob_tok, spec=spec, max_chunks=cfg2.max_chunks)
        if table is not None:
            ds.use_device_table(table)
        return ds

    table = make_table(feats)
    train_ds, val_ds = (mk_ds(dataset_cls, feats, table, train_ex),
                        mk_ds(dataset_cls, feats, table, val_ex))
    val_dl = DataLoader(val_ds, args.eval_batch)

    # ---- stage-1 data: the stage-2 split unless another task's (or a
    # mixture) was asked for; a file shared with --jsonl gives both stages
    # the same train slice, so no held-out example is pretrained on
    s1_task = args.stage1_task or args.task
    s1_jsonl = args.stage1_jsonl or args.jsonl
    s1_cross = (s1_task, s1_jsonl) != (args.task, args.jsonl)
    if s1_cross and not args.stage1_npz:
        groups = {}
        for entry in s1_jsonl.split(","):
            task, path = split_entry(entry, s1_task)
            if task == "both":
                raise ValueError("--stage1_task both needs pmr:/vcr:-prefixed "
                                 f"--stage1_jsonl entries; got {entry!r}")
            groups.setdefault(task, []).extend(LOADERS[task][0](path,
                                                                limit=args.limit or None))
        feats1 = synthetic_features({ex.img_id for exs in groups.values() for ex in exs},
                                    enc_cfg.img_feature_dim, max_regions=max_regions)
        table1 = make_table(feats1)
        train_parts, val_parts = [], []
        for task in sorted(groups):
            exs = groups[task]
            order1 = np.random.default_rng(args.seed).permutation(len(exs))
            n1 = int(len(exs) * args.train_frac)
            cls1 = LOADERS[task][1]
            train_parts.append(mk_ds(cls1, feats1, table1, [exs[i] for i in order1[:n1]]))
            val_parts.append(mk_ds(cls1, feats1, table1, [exs[i] for i in order1[n1:]]))
        if len(train_parts) == 1:
            train_ds1, val_ds1 = train_parts[0], val_parts[0]
        else:
            train_ds1, val_ds1 = MixedDataset(train_parts), MixedDataset(val_parts)
        if len(train_ds1) and len(train_ds1) < args.stage1_batch:
            args.stage1_batch = len(train_ds1)
        val_dl1 = DataLoader(val_ds1, args.eval_batch)
        logger.info("stage-1 data: %s (%s) -> %d train / %d held-out",
                    s1_task, s1_jsonl, len(train_ds1), len(val_ds1))
    else:
        train_ds1, val_dl1 = train_ds, val_dl

    # ================= stage 1: ChunkAlign pretrain =================
    if args.stage1_npz:
        # the reference's deployment shape: graft a checkpoint trained elsewhere
        with np.load(args.stage1_npz) as z:
            sd = {k: z[k] for k in z.files}
        logger.info("stage-1 skipped: %d keys loaded from %s", len(sd), args.stage1_npz)
        s1 = None
        s1_wall = 0.0
    else:
        enc1_cfg = dataclasses.replace(enc_cfg, dtype=s1_dtype)
        if args.stage1_dropout is not None:
            enc1_cfg = dataclasses.replace(enc1_cfg, hidden_dropout_prob=args.stage1_dropout,
                                           attention_probs_dropout_prob=args.stage1_dropout)
        model1 = ChunkAlignClassifier(
            enc1_cfg, cfg2.chunkalign, num_labels=cfg2.num_labels,
            max_chunks=cfg2.max_chunks, align_weight=args.align_weight, device=device,
            generator=torch.Generator(device=device).manual_seed(args.seed))
        tcfg1 = TrainConfig(
            learning_rate=args.lr1, warmup_steps=args.warmup, max_steps=args.stage1_steps,
            num_train_epochs=10_000, per_device_batch_size=args.stage1_batch,
            valid_steps=args.stage1_valid_steps or args.valid_steps, epoch_begin=1,
            seed=args.seed, freeze_encoders=False, seq_enc_lr_scale=args.seq_lr_scale,
            compute_dtype=s1_dtype)
        train_dl1 = DataLoader(train_ds1, args.stage1_batch, shuffle=True, seed=args.seed,
                               drop_last=True)
        # best-accuracy checkpoints of the parameters alone: the surgery
        # grafts the best stage-1 towers, not the last ones
        trainer1 = Trainer(model1, tcfg1, train_dl1, val_dl1, logger=logger,
                           checkpoint_dir=os.path.join(args.out, "stage1_ckpt"),
                           checkpoint_params_only=True, device=device)
        state1 = trainer1.init_state()
        s1_base = trainer1.evaluate()
        logger.info("stage-1 held-out accuracy at random init: %.4f", s1_base)
        t0 = time.time()
        if args.stage1_steps > 0:
            state1 = trainer1.fit(state1)
        s1_wall = time.time() - t0
        s1_final = trainer1.evaluate()
        logger.info("stage-1 done: best %.4f final %.4f (%.0fs)", trainer1.best_acc,
                    s1_final, s1_wall)
        params1 = model1.state_dict()
        if trainer1.ckpt.latest_step() is not None:
            params1 = trainer1.ckpt.restore_params(best=True)
            logger.info("stage-1: restored best checkpoint (step %s) for export",
                        trainer1.ckpt.best_step())
        # the export is the reference's checkpoint layout
        sd = export_chunkalign_cls_state_dict(params1, enc_cfg)
        npz = os.path.join(args.out, "chunkalign_cls_state_dict.npz")
        np.savez(npz, **sd)
        logger.info("stage-1 export: %d keys -> %s", len(sd), npz)
        s1 = dict(baseline_acc=s1_base, best_acc=trainer1.best_acc, final_acc=s1_final,
                  history=trainer1.history)
        # free the stage-1 model, its optimizer and the cached blocks
        # before the composite's step needs them
        del model1, trainer1, state1, params1
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # ================= stage 2: surgery + prefix-tune =================
    model2 = ModCRModel(cfg2, device=device,
                        generator=torch.Generator(device=device).manual_seed(args.seed))
    train_dl2 = DataLoader(train_ds, args.batch, shuffle=True, seed=args.seed + 1,
                           drop_last=True)
    tcfg2 = TrainConfig(
        learning_rate=args.lr2, warmup_steps=args.warmup, max_steps=args.stage2_steps,
        num_train_epochs=10_000, per_device_batch_size=args.batch,
        valid_steps=args.valid_steps, epoch_begin=1, seed=args.seed,
        compute_dtype="float32" if args.tiny else "bfloat16")
    trainer2 = Trainer(model2, tcfg2, train_dl2, val_dl, logger=logger, device=device)
    # the reference's surgery: seq_enc through the chunkalign strip
    # (run_PMR_ModCR.py:752-763), the global tower through the oscar slot
    params2 = dict(model2.state_dict())
    global_sd = {k[len("global_enc."):]: v for k, v in sd.items()
                 if k.startswith("global_enc.")}
    report = assemble_modcr_params(params2, cfg2, oscar_sd=global_sd, chunkalign_sd=sd)
    model2.load_state_dict(params2, strict=True)
    logger.info("surgery: %d keys grafted, %d skipped-dead", len(report.consumed),
                len(report.skipped))
    state2 = trainer2.init_state()

    s2_base = trainer2.evaluate()
    logger.info("stage-2 held-out accuracy after surgery, before tuning: %.4f", s2_base)
    trainer2.history.append({"epoch": 0, "step": 0, "val_acc": s2_base,
                             "train_loss": None, "train_acc": None})
    t0 = time.time()
    if args.stage2_steps > 0:
        state2 = trainer2.fit(state2)
    s2_wall = time.time() - t0
    s2_final = trainer2.evaluate()

    if args.stage1_npz:
        stage1_curve = {"npz": args.stage1_npz, "keys": len(sd)}
    else:
        stage1_curve = {"steps": args.stage1_steps, "baseline_acc": s1["baseline_acc"],
                        "best_acc": s1["best_acc"], "final_acc": s1["final_acc"],
                        "wall_seconds": round(s1_wall, 1), "history": s1["history"]}
        if s1_cross:
            stage1_curve["task"] = s1_task
            stage1_curve["data"] = ",".join(os.path.basename(x) for x in s1_jsonl.split(","))
    curve = {
        "task": args.task,
        "data": ",".join(os.path.basename(x) for x in args.jsonl.split(",")),
        "n_train": len(train_ex), "n_val": len(val_ex),
        "batch": args.batch, "stage1_batch": args.stage1_batch,
        "lr1": args.lr1, "lr2": args.lr2,
        "align_weight": args.align_weight, "seed": args.seed,
        "tiny": args.tiny,
        "stage1": stage1_curve,
        "stage2": {"steps": args.stage2_steps, "post_surgery_acc": s2_base,
                   "best_acc": trainer2.best_acc, "final_acc": s2_final,
                   "wall_seconds": round(s2_wall, 1), "history": trainer2.history},
    }
    path = os.path.join(args.out, "curve.json")
    with open(path, "w") as f:
        json.dump(curve, f, indent=1)
    logger.info("wrote %s", path)
    print(json.dumps({
        "stage1_best_acc": round(s1["best_acc"], 4) if s1 is not None else None,
        "post_surgery_acc": round(s2_base, 4),
        "stage2_best_acc": round(trainer2.best_acc, 4),
        "stage2_final_acc": round(s2_final, 4),
        "wall_seconds": round(s1_wall + s2_wall, 1),
    }))
    return curve


if __name__ == "__main__":
    main()
