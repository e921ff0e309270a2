"""PMR trainer entry point (port of the JAX package's ``cli/run_pmr.py``;
run_PMR_ModCR.py parity).

Usage (reference README.md:22-26 analogue)::

    python -m multimodal_context_reasoning_torch.cli.run_pmr --do_train \\
        --train_file pmr_data/train-ori.jsonl --val_file pmr_data/val-ori.jsonl \\
        --img_feat_file pmr_feats.pkl --output_dir output/pmr

    python -m multimodal_context_reasoning_torch.cli.run_pmr --do_test \\
        --test_file pmr_data/test-ori.jsonl --img_feat_file pmr_feats.pkl \\
        --eval_model_dir output/pmr

The model runs on the GPU (``--device``, default ``cuda``; without a card
the command raises, ``--device cpu`` asks for the CPU).  ``--do_train``
writes ``config.json`` and best-accuracy checkpoints under
``<output_dir>/ckpt``; ``--do_test`` restores the best of them from
``--eval_model_dir`` (with its ``config.json``) and writes
``result_test_ModICR_<task>.json``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from multimodal_context_reasoning_torch.cli.common import (
    batch_spec,
    build_arg_parser,
    configs_from_args,
    load_image_features,
    load_tokenizers,
    write_test_predictions,
)
from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.data.pmr import PMRDataset, load_pmr_jsonl
from multimodal_context_reasoning_torch.interop.assemble import assemble_from_files
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.train.checkpoint import (
    CheckpointManager,
    save_config,
)
from multimodal_context_reasoning_torch.train.step import eval_step
from multimodal_context_reasoning_torch.train.trainer import Trainer
from multimodal_context_reasoning_torch.utils.logging import setup_logger
from multimodal_context_reasoning_torch.utils.misc import mkdir, set_seed


def main(argv=None, *, task="pmr", dataset_cls=PMRDataset, load_fn=load_pmr_jsonl):
    """Run ``--do_train`` (returns the final ``TrainState``) or
    ``--do_test`` (returns the test accuracy)."""
    args = build_arg_parser(task).parse_args(argv)
    cfg, tcfg = configs_from_args(args)
    # restore_training_settings analogue (run_PMR_ModCR.py:370-400): when
    # evaluating a saved run, its config.json overrides the geometry flags
    # so shapes match the checkpoint.
    cfg_path = os.path.join(args.eval_model_dir, "config.json")
    restored = bool(args.eval_model_dir) and not args.do_train and os.path.exists(cfg_path)
    if restored:
        with open(cfg_path) as f:
            cfg = ModCRConfig.from_json(f.read())
    if not (args.do_train or args.do_test):
        raise SystemExit("pass --do_train or --do_test")
    device = resolve_device(args.device)

    mkdir(args.output_dir)
    logger = setup_logger(f"modcr.{task}", args.output_dir)
    set_seed(args.seed)
    if restored:
        logger.info("restored model config from %s", cfg_path)
    logger.info("device=%s", device)

    feats = load_image_features(args.img_feat_file, cfg.global_encoder.img_feature_dim)
    bert, rob = load_tokenizers(args, cfg)

    def make_dataset(path):
        return dataset_cls(load_fn(path, limit=args.limit or None), feats, bert, rob,
                           spec=batch_spec(cfg), max_chunks=cfg.max_chunks)

    model = ModCRModel(cfg, device=device,
                       generator=torch.Generator(device=device).manual_seed(args.seed))

    def maybe_import_reference_weights():
        """Graft reference torch checkpoints into the model when any
        --*_ckpt is given (run_PMR_ModCR.py:709-835 load sequence)."""
        if not any((args.oscar_ckpt, args.chunkalign_ckpt, args.roberta_ckpt,
                    args.modcr_ckpt)):
            return
        params = dict(model.state_dict())
        report = assemble_from_files(
            params, cfg,
            oscar_path=args.oscar_ckpt or None,
            chunkalign_path=args.chunkalign_ckpt or None,
            roberta_path=args.roberta_ckpt or None,
            modcr_path=args.modcr_ckpt or None,
            cold_start=args.cold_start,
        )
        model.load_state_dict(params, strict=True)
        logger.info("imported reference weights (cold_start=%s): %s",
                    args.cold_start, report.summary())
        for key, reason in sorted(report.skipped.items()):
            logger.debug("skipped %s: %s", key, reason)

    if args.do_train:
        train_ds = make_dataset(args.train_file)
        val_ds = make_dataset(args.val_file) if args.val_file else None
        train_dl = DataLoader(train_ds, args.per_gpu_train_batch_size, shuffle=True,
                              seed=args.seed, drop_last=True)
        val_dl = DataLoader(val_ds, args.per_gpu_eval_batch_size) if val_ds else None
        trainer = Trainer(
            model, tcfg, train_dl, val_dl,
            checkpoint_dir=os.path.join(args.output_dir, "ckpt"),
            logger=logger,
            freeze_roberta_body=(task == "vcr"),  # run_vcr_ModCR.py:783-787
            device=device,
        )
        save_config(args.output_dir, "config.json", cfg)
        state = trainer.init_state()
        maybe_import_reference_weights()
        state = trainer.fit(state)
        logger.info("training done: best val acc %.4f", trainer.best_acc)
        return state

    test_ds = make_dataset(args.test_file)
    test_dl = DataLoader(test_ds, args.per_gpu_eval_batch_size)
    maybe_import_reference_weights()
    if args.eval_model_dir:
        # params-only, best-metric checkpoint (run_PMR_ModCR.py:236-239
        # deploys the best-accuracy save)
        model.load_state_dict(CheckpointManager(
            os.path.join(args.eval_model_dir, "ckpt")).restore_params(best=True))
    all_logits = []
    correct = count = 0.0
    for batch in test_dl:
        out = eval_step(model, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        keep = batch["example_mask"] > 0
        all_logits.append(out["logits"].float().cpu().numpy()[keep])
        correct += float(out["correct"])
        count += float(out["count"])
    logits = np.concatenate(all_logits, axis=0)
    acc = correct / max(count, 1.0)
    logger.info("test accuracy: %.4f over %d examples", acc, int(count))
    out_path = os.path.join(args.output_dir, f"result_test_ModICR_{task}.json")
    write_test_predictions(out_path, test_ds.examples, logits)
    logger.info("wrote %s", out_path)
    return acc


if __name__ == "__main__":
    main()
