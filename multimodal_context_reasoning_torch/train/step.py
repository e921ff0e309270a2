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

On a mesh (``TrainState.mesh``) each rank steps on its own block of the
global batch's rows (parallel/partition.py::local_rows, or a sharded
loader).  The gradients are averaged over the ``data`` group every
micro-step, before the accumulator, as JAX's psum does: one all-reduce of a
flat buffer per dtype.  The loss is an unweighted mean over rows, so with
equal blocks the mean of the ranks' gradients is the global batch's.
``DistributedDataParallel`` cannot do this: its reducer sees only gradients
accumulated into ``.grad``, and the step takes them with
``torch.autograd.grad``.  ``correct`` and ``count`` are summed over the
group, ``loss`` and ``align_loss`` averaged; the gradient norm is the whole
model's (train/optim.py::sharded_global_norm).
"""

from __future__ import annotations

from typing import Dict

import torch

from multimodal_context_reasoning_torch.parallel.comm import all_reduce_, gather_rows, group_size
from multimodal_context_reasoning_torch.parallel.mesh import axis_group, axis_index
from multimodal_context_reasoning_torch.train.graphs import SegmentedGraphs
from multimodal_context_reasoning_torch.train.optim import Grads
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.utils.profiling import span

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


def average_gradients(grads: Grads, group) -> Grads:
    """Mean of ``grads`` over ``group``: one all-reduce of one flat buffer
    per dtype (a None gradient stays None: every rank runs the same graph)."""
    n = group_size(group)
    if n == 1:
        return grads
    out = dict(grads)
    by_dtype: Dict[torch.dtype, list] = {}
    for name, g in grads.items():
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(name)
    with span("step.allreduce"):
        for names in by_dtype.values():
            flat = all_reduce_(torch.cat([grads[k].reshape(-1) for k in names]), group)
            flat.div_(n)
            offset = 0
            for k in names:
                size = grads[k].numel()
                out[k] = flat[offset:offset + size].view_as(grads[k])
                offset += size
    return out


def _reduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """``correct`` / ``count`` summed over ``group``, the rest averaged."""
    n = group_size(group)
    if n == 1:
        return metrics
    keys = list(metrics)
    vals = all_reduce_(torch.stack([metrics[k].float() for k in keys]), group)
    return {k: v if k in ("correct", "count") else v / n for k, v in zip(keys, vals)}


def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
    """Forward, backward and one micro-step of the optimizer (model in train
    mode, so dropout is on where the config has it).  On a mesh ``batch``
    is this rank's rows."""
    with span("step.train"):
        model = state.model.train()
        out = model(model_inputs(batch))
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        with span("step.backward"):
            grads = torch.autograd.grad(out.loss, [p for _, p in named], allow_unused=True)
        grads = {n: g for (n, _), g in zip(named, grads)}
        metrics = _metrics(out, batch)
        data = axis_group(state.mesh, "data")
        grads = average_gradients(grads, data)
        metrics = _reduce_metrics(metrics, data)
        with span("step.optimizer"):
            metrics["grad_norm"] = state.optimizer.global_norm(grads)
            state.apply_gradients(grads)
        return metrics


def _eval_forward(model: torch.nn.Module, batch: Batch) -> Dict[str, torch.Tensor]:
    mesh = getattr(model, "tp_mesh", None)
    out = model(model_inputs(batch))
    m = _metrics(out, batch)
    data = axis_group(mesh, "data")
    logits = gather_rows(out.logits, axis_index(mesh, "data"), data)
    m = _reduce_metrics({k: m[k] for k in ("correct", "count", "loss")}, data)
    return {"logits": logits, "correct": m["correct"], "count": m["count"],
            "loss": m["loss"]}


def _eval_mode(model: torch.nn.Module) -> None:
    """``model.eval()``, skipped when no module is in training mode (the
    recursive ``train(False)`` costs milliseconds of host time a call at
    ModCR's 851 modules; this walk about a tenth of that)."""
    stack = [model]
    while stack:
        m = stack.pop()
        if m is None:
            continue
        if m.training:
            model.eval()
            return
        stack.extend(m._modules.values())


# the forward's CUDA graphs, one per model (train/graphs.py)
EVAL_GRAPHS = SegmentedGraphs(_eval_forward)


def eval_step(model: torch.nn.Module, batch: Batch) -> Dict[str, torch.Tensor]:
    """Deterministic forward: logits, accuracy count and loss.  On a mesh
    (the model's ``tp_mesh``) ``batch`` is this rank's rows and the logits
    of every data index come back stacked in rank order.

    On a card, with no mesh and the whole batch on the model's device, the
    forward runs as segmented CUDA graphs (:data:`EVAL_GRAPHS`): eager on
    the first call of a geometry, captured on the second in a row, replayed
    after.  The graph copies each batch into tensors of its own; ``batch``
    is only read."""
    with span("step.eval"):
        _eval_mode(model)
        with torch.inference_mode():
            return EVAL_GRAPHS(model, batch)
