"""Train and eval steps (port of the JAX package's ``train/step.py``).

The optimized loss is the 4-way soft CE alone (run_PMR_ModCR.py:204-208);
metrics also report the alignment loss, the global gradient norm over every
parameter that received a gradient (``optax_global_norm``) and the accuracy
count.  Accuracy follows the reference (run_PMR_ModCR.py:266-274): the
argmax over the candidate logits must equal the argmax of the multi-hot
label row, so a multi-label row credits only its first gold candidate, and
rows are weighted by ``example_mask`` so a padded last batch counts only its
real examples.  Metrics stay on the device: reading them is the caller's
synchronization point.
"""

from __future__ import annotations

from typing import Dict

import torch

from multimodal_context_reasoning_torch.train.optim import global_norm
from multimodal_context_reasoning_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def model_inputs(batch: Batch) -> Batch:
    """The model's inputs: ``example_mask`` dropped and, in device-table
    mode (data/device_table.py), the batch's image features gathered on the
    device from the resident table by ``img_row``."""
    batch = {k: v for k, v in batch.items() if k != "example_mask"}
    if "img_row" in batch:
        table = batch.pop("feat_table")
        tmask = batch.pop("feat_mask_table")
        rows = batch.pop("img_row")
        batch["img_feat"] = table[rows]
        batch["img_mask"] = tmask[rows]
    return batch


def _metrics(out, batch: Batch) -> Dict[str, torch.Tensor]:
    logits = out.logits.detach()                       # [B, K]
    labels = batch["label"].reshape(logits.shape)      # [B, K] multi-hot
    hit = logits.argmax(dim=-1) == labels.argmax(dim=-1)
    w = batch.get("example_mask")
    if w is None:
        w = torch.ones(logits.shape[:1], device=logits.device)
    return {
        "loss": out.loss.detach(),
        "align_loss": out.align_loss.detach(),
        "correct": (hit.float() * w).sum(),
        "count": w.sum(),
    }


def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
    """Forward, backward and one micro-step of the optimizer (model in train
    mode, so dropout is on where the config has it)."""
    model = state.model.train()
    out = model(model_inputs(batch))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(out.loss, [p for _, p in named], allow_unused=True)
    grads = {n: g for (n, _), g in zip(named, grads)}
    metrics = _metrics(out, batch)
    metrics["grad_norm"] = global_norm([g for g in grads.values() if g is not None])
    state.apply_gradients(grads)
    return metrics


def eval_step(model: torch.nn.Module, batch: Batch) -> Dict[str, torch.Tensor]:
    """Deterministic forward: logits, accuracy count and loss."""
    model.eval()
    with torch.inference_mode():
        out = model(model_inputs(batch))
        m = _metrics(out, batch)
    return {"logits": out.logits, "correct": m["correct"], "count": m["count"],
            "loss": m["loss"]}
