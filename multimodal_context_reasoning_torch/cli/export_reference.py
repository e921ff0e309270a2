"""Export a trained checkpoint to the reference's torch format (port of the
JAX package's ``cli/export_reference.py``).

    python -m multimodal_context_reasoning_torch.cli.export_reference \\
        --eval_model_dir output/pmr --out modcr_exported.pth

Reads the run's best checkpoint (``run_pmr --do_train``'s ``ckpt/``; the
latest when none is ranked) and its ``config.json``, and writes the
reference's ``{'net': state_dict}`` form (run_PMR_ModCR.py:236-239) with
``torch.save`` in the legacy format, as JAX ``interop/export.py:257``
writes it.  The port's state dict is already the reference layout, every
key the JAX export writes included, so the file loads into
``ModCRModel`` with ``strict=True``, into the reference's ``--do_test``
path and through ``interop/assemble.py``.
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--eval_model_dir", required=True,
                   help="training output dir (ckpt/ + config.json)")
    p.add_argument("--out", required=True, help="target .pth path")
    p.add_argument("--step", type=int, default=None,
                   help="explicit checkpoint step (default: best, then latest)")
    args = p.parse_args(argv)

    from multimodal_context_reasoning_torch.core.config import ModCRConfig
    from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager

    # the run's config must be there, as the JAX command reads it
    with open(os.path.join(args.eval_model_dir, "config.json")) as f:
        ModCRConfig.from_json(f.read())
    params = CheckpointManager(os.path.join(args.eval_model_dir, "ckpt")).restore_params(
        args.step, best=True)
    torch.save({"net": {k: v.float().contiguous() for k, v in params.items()}}, args.out,
               _use_new_zipfile_serialization=False)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
