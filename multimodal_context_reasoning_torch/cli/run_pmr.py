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
``result_test_ModICR_<task>.json``.  ``--quantize int8`` runs the test
forwards through the W8A8 route; it holds for a config restored from
``config.json`` too, which the JAX CLI's restore drops.  ``--device_features``
keeps the image-feature set on the device (data/device_table.py) for every
split; ``--profile_dir`` and ``--tensorboard_dir`` go to the trainer.

Over several GPUs, one process each::

    torchrun --nproc_per_node 8 -m multimodal_context_reasoning_torch.cli.run_pmr \\
        --multihost --mesh_model 2 --do_train ...

``--multihost`` joins the process group; ``--mesh_data`` / ``--mesh_model``
shape the ("data", "model") mesh (cli/common.py::mesh_from_args).  The batch
sizes are global: each data index trains on its share of
``--per_gpu_train_batch_size`` (the JAX loader's strided shard of the epoch
order) and evaluates its block of each evaluation batch; rank 0 writes the
config, the checkpoints and the prediction file.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from multimodal_context_reasoning_torch.cli.common import (
    batch_spec,
    build_arg_parser,
    configs_from_args,
    load_image_features,
    load_tokenizers,
    maybe_init_distributed,
    mesh_from_args,
    write_test_predictions,
)
from multimodal_context_reasoning_torch.core.config import ModCRConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.data.device_table import DeviceFeatureTable
from multimodal_context_reasoning_torch.data.loader import DataLoader
from multimodal_context_reasoning_torch.data.pmr import PMRDataset, load_pmr_jsonl
from multimodal_context_reasoning_torch.interop.assemble import assemble_from_files
from multimodal_context_reasoning_torch.models.modcr import ModCRModel
from multimodal_context_reasoning_torch.parallel.mesh import axis_index, axis_size
from multimodal_context_reasoning_torch.parallel.partition import local_rows, shard_module_
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
    maybe_init_distributed(args)
    mesh = mesh_from_args(args)
    lead = mesh is None or torch.distributed.get_rank() == 0
    n_data, data_index = axis_size(mesh, "data"), axis_index(mesh, "data")
    if mesh is not None:
        tcfg = dataclasses.replace(tcfg, mesh_shape=tuple(mesh.shape))
    # restore_training_settings analogue (run_PMR_ModCR.py:370-400): when
    # evaluating a saved run, its config.json overrides the geometry flags
    # so shapes match the checkpoint.
    cfg_path = os.path.join(args.eval_model_dir, "config.json")
    restored = bool(args.eval_model_dir) and not args.do_train and os.path.exists(cfg_path)
    if restored:
        with open(cfg_path) as f:
            cfg = ModCRConfig.from_json(f.read()).with_quantize(args.quantize)
    if not (args.do_train or args.do_test):
        raise SystemExit("pass --do_train or --do_test")
    device = resolve_device(args.device)

    mkdir(args.output_dir)
    logger = setup_logger(f"modcr.{task}", args.output_dir)
    set_seed(args.seed)
    if restored:
        logger.info("restored model config from %s", cfg_path)
    logger.info("device=%s mesh=%s", device, None if mesh is None else tuple(mesh.shape))

    feats = load_image_features(args.img_feat_file, cfg.global_encoder.img_feature_dim)
    bert, rob = load_tokenizers(args, cfg)

    device_table = None
    if args.device_features:
        # from a dict or the FeatureStore (keys() and __getitem__)
        device_table = DeviceFeatureTable.for_config(feats, cfg, device=device)
        logger.info("device feature table resident: %d images, %.1f MB on %s",
                    len(device_table.row), device_table.nbytes / 1e6, device)

    def make_dataset(path):
        ds = dataset_cls(load_fn(path, limit=args.limit or None), feats, bert, rob,
                         spec=batch_spec(cfg), max_chunks=cfg.max_chunks)
        if device_table is not None:
            ds.use_device_table(device_table)
        return ds

    if device_table is not None and mesh is not None:
        device_table.place(mesh)

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
        # each data index loads its strided shard, its share of the batch
        shard = None if mesh is None else (data_index, n_data)
        train_dl = DataLoader(train_ds, args.per_gpu_train_batch_size // n_data,
                              shuffle=True, seed=args.seed, drop_last=True, shard=shard)
        val_dl = (DataLoader(val_ds, args.per_gpu_eval_batch_size // n_data, shard=shard)
                  if val_ds else None)
        # before the trainer shards the model over the mesh
        maybe_import_reference_weights()
        trainer = Trainer(
            model, tcfg, train_dl, val_dl,
            checkpoint_dir=os.path.join(args.output_dir, "ckpt"),
            logger=logger,
            freeze_roberta_body=(task == "vcr"),  # run_vcr_ModCR.py:783-787
            device=device,
            profile_dir=args.profile_dir or None,
            profile_start=2 if args.tiny else 10,
            tensorboard_dir=args.tensorboard_dir or None,
            mesh=mesh,
        )
        if lead:
            save_config(args.output_dir, "config.json", cfg)
        state = trainer.fit(trainer.init_state())
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
    if mesh is not None:
        # every rank reads the whole test set; each forwards its block of
        # a batch and eval_step gathers the logits
        shard_module_(model, mesh)
    all_logits = []
    correct = count = 0.0
    for batch in test_dl:
        out = eval_step(model, local_rows({k: v if isinstance(v, torch.Tensor)
                                           else torch.from_numpy(v).to(device)
                                           for k, v in batch.items()}, mesh))
        keep = batch["example_mask"] > 0
        all_logits.append(out["logits"].float().cpu().numpy()[keep])
        correct += float(out["correct"])
        count += float(out["count"])
    logits = np.concatenate(all_logits, axis=0)
    acc = correct / max(count, 1.0)
    logger.info("test accuracy: %.4f over %d examples", acc, int(count))
    out_path = os.path.join(args.output_dir, f"result_test_ModICR_{task}.json")
    if lead:
        write_test_predictions(out_path, test_ds.examples, logits)
        logger.info("wrote %s", out_path)
    return acc


if __name__ == "__main__":
    main()
