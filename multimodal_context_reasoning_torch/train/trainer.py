"""Host-side training loop (port of the JAX package's ``train/trainer.py``).

Rebuilds the reference trainer (run_PMR_ModCR.py:115-241): an epoch loop
over a seeded per-epoch shuffle, mid-epoch validation gated by
``epoch_begin`` / ``valid_steps`` with best-accuracy checkpoints
(:230-239), and resume from the latest checkpoint (:146-156).  Gradient
accumulation lives in the train state (:class:`MaskedMultiSteps`).  Per-step
metrics are summed on the device and read only at validation points and
epoch ends, so the micro-step path has no host synchronization.  The model
runs on the GPU unless the caller passes ``device="cpu"``.

``profile_dir`` captures micro-steps ``[profile_start, profile_start +
profile_steps)`` with ``torch.profiler`` (utils/profiling.py) into a Chrome
trace there; ``tensorboard_dir`` writes the meters at the same
synchronization points the meter drains at (utils/tensorboard.py), so
neither adds a host read to the micro-step path outside the capture.

``mesh`` (a ("data", "model") ``DeviceMesh``, parallel/mesh.py; by default
the one ``TrainConfig.mesh_shape`` names when it is not (1, 1)) trains one
process per device: the model is sharded over the model axis
(``shard_module_``, unless the caller did it), each rank's loaders yield its
data index's rows (``DataLoader(shard=...)``), the step averages the
gradients over the data axis (train/step.py), and the global RNG is seeded
from ``TrainConfig.seed`` plus the data index, so the ranks of one model
group draw the same dropout masks on their replicated activations (and on
their local heads' probabilities: rank r's heads share their masks with
the other ranks' heads at the same local index).  Checkpoints hold the
whole model (train/checkpoint.py).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import TrainConfig
from multimodal_context_reasoning_torch.core.device import resolve_device
from multimodal_context_reasoning_torch.parallel.mesh import axis_index, make_mesh
from multimodal_context_reasoning_torch.parallel.partition import shard_module_
from multimodal_context_reasoning_torch.train.checkpoint import CheckpointManager
from multimodal_context_reasoning_torch.train.state import TrainState
from multimodal_context_reasoning_torch.train.step import eval_step, train_step
from multimodal_context_reasoning_torch.utils.metrics import MetricLogger
from multimodal_context_reasoning_torch.utils.profiling import start_trace, stop_trace


class Trainer:
    def __init__(
        self,
        model: nn.Module,
        cfg: TrainConfig,
        train_loader,
        val_loader=None,
        *,
        checkpoint_dir: Optional[str] = None,
        logger: Optional[logging.Logger] = None,
        freeze_roberta_body: bool = False,
        checkpoint_params_only: bool = False,
        device: Union[str, torch.device] = "cuda",
        profile_dir: Optional[str] = None,
        profile_start: int = 10,
        profile_steps: int = 3,
        tensorboard_dir: Optional[str] = None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        if mesh is None and tuple(cfg.mesh_shape) != (1, 1):
            mesh = make_mesh(tuple(cfg.mesh_shape))
        self.mesh = mesh
        # the default start skips the first steps (kernel builds, warm-up)
        self.profile_dir = profile_dir
        self.profile_start = profile_start
        self.profile_steps = profile_steps
        self.trace_path: Optional[str] = None   # the last capture's file
        self.tb = None
        if tensorboard_dir is not None:
            from multimodal_context_reasoning_torch.utils.tensorboard import (
                TensorboardLogger,
            )

            self.tb = TensorboardLogger(tensorboard_dir)
        self.model = model.to(self.device)
        if mesh is not None:
            if getattr(self.model, "tp_mesh", None) is None:
                shard_module_(self.model, mesh)
            torch.manual_seed(cfg.seed + axis_index(mesh, "data"))
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger or logging.getLogger("modcr")
        self.freeze_roberta_body = freeze_roberta_body

        steps_per_epoch = max(len(train_loader) // cfg.gradient_accumulation_steps, 1)
        # t_total semantics: run_PMR_ModCR.py:118-124
        if cfg.max_steps > 0:
            self.t_total = cfg.max_steps
            self.num_epochs = cfg.max_steps // steps_per_epoch + 1
        else:
            self.t_total = steps_per_epoch * cfg.num_train_epochs
            self.num_epochs = cfg.num_train_epochs

        # attributes, so a caller can wrap them (chip_smoke.py counts the
        # kernel launches of each step this way)
        self.train_step = train_step
        self.eval_step = eval_step
        # params_only: best-accuracy saves without the AdamW moments (no
        # resume from them)
        self.ckpt = (CheckpointManager(checkpoint_dir, params_only=checkpoint_params_only)
                     if checkpoint_dir else None)
        self.best_acc = 0.0
        # steps-vs-accuracy curve: one dict per mid-training validation
        self.history: list = []

    def init_state(self) -> TrainState:
        return TrainState.create(self.model, self.cfg, self.t_total,
                                 freeze_roberta_body=self.freeze_roberta_body)

    def resume(self, state: TrainState) -> TrainState:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return state
        state = self.ckpt.restore(state)
        self.logger.info("Resumed from step %d", state.step)
        return state

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Host arrays copied to the device; tensors (a device table's,
        data/device_table.py) pass as they are, so the table is never
        copied again."""
        return {k: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def evaluate(self, model: Optional[nn.Module] = None) -> float:
        """Full-validation accuracy (run_PMR_ModCR.py:243-280); the counts
        stay on the device until the last batch."""
        assert self.val_loader is not None
        model = self.model if model is None else model
        correct = count = None
        for batch in self.val_loader:
            out = self.eval_step(model, self.to_device(batch))
            correct = out["correct"] if correct is None else correct + out["correct"]
            count = out["count"] if count is None else count + out["count"]
        if correct is None:
            return 0.0
        return float(correct) / max(float(count), 1.0)

    def fit(self, state: Optional[TrainState] = None) -> TrainState:
        if state is None:
            state = self.init_state()
        state = self.resume(state)
        meter = MetricLogger()
        accum = self.cfg.gradient_accumulation_steps
        micro = 0
        sums: Optional[Dict[str, torch.Tensor]] = None
        since_fetch = 0

        def drain_sums():
            """One synchronization point: fold the device sums into the
            meter as window averages."""
            nonlocal sums, since_fetch
            if sums is None or since_fetch == 0:
                return
            fetched = {k: float(v) for k, v in sums.items()}
            meter.update(
                loss=fetched["loss"] / since_fetch,
                acc=fetched["correct"] / max(fetched["count"], 1.0),
                align=fetched["align_loss"] / since_fetch,
            )
            sums = None
            since_fetch = 0

        prof = None

        def maybe_profile(micro_done: int) -> None:
            """Start or stop the capture around micro-steps [profile_start,
            profile_start + profile_steps)."""
            nonlocal prof
            if self.profile_dir is None:
                return
            if prof is None and micro_done == self.profile_start:
                prof = start_trace(self.device)
            elif prof is not None and micro_done >= self.profile_start + self.profile_steps:
                self.trace_path = stop_trace(prof, self.profile_dir, self.device)
                prof = None
                self.logger.info("profiler trace written to %s", self.trace_path)

        capped = False  # max_steps reached: stop BEFORE any further update
        for epoch in range(self.num_epochs):
            if capped:
                break
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(epoch)
            for batch in self.train_loader:
                maybe_profile(micro)
                metrics = self.train_step(state, self.to_device(batch))
                micro += 1
                maybe_profile(micro)
                sums = metrics if sums is None else {k: sums[k] + metrics[k] for k in sums}
                since_fetch += 1
                if micro % accum != 0:
                    continue
                opt_step = micro // accum
                if (self.val_loader is not None
                        and epoch >= self.cfg.epoch_begin - 1
                        and opt_step % self.cfg.valid_steps == 0):
                    drain_sums()
                    acc = self.evaluate(state.model)
                    self.logger.info("epoch %d step %d: val accuracy %.4f (train %s)",
                                     epoch + 1, opt_step, acc, meter)
                    last = lambda k: (float(meter.meters[k].deque[-1])
                                      if meter.meters[k].deque else None)
                    self.history.append({
                        "epoch": epoch + 1, "step": opt_step, "val_acc": acc,
                        "train_loss": last("loss"), "train_acc": last("acc"),
                    })
                    if self.tb is not None:
                        self.tb.log_meters(meter, opt_step)
                        self.tb.log_scalar("val_acc", acc, opt_step)
                    if acc > self.best_acc:
                        self.best_acc = acc
                        if self.ckpt is not None:
                            self.ckpt.save(state, {"accuracy": acc})
                if self.cfg.max_steps > 0 and opt_step >= self.cfg.max_steps:
                    capped = True  # also exits the epoch loop, or the next
                    break          # epoch would train one extra group
            drain_sums()
            self.logger.info("epoch %d done: %s", epoch + 1, meter)
            if self.tb is not None:
                self.tb.log_meters(meter, micro // accum)
        if prof is not None:   # training ended inside the capture window
            self.trace_path = stop_trace(prof, self.profile_dir, self.device)
        if self.tb is not None:
            self.tb.close()
        return state
