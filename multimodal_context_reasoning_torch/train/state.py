"""Train state (port of the JAX package's ``train/state.py``).

The JAX state is an immutable pytree carried through a jitted step; here it
is the model, whose fp32 parameters the optimizer updates in place, the
optimizer, the gradient accumulator, the micro-step count and the mesh the
model was sharded over (parallel/partition.py; ``None`` on one device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import TrainConfig
from multimodal_context_reasoning_torch.train.optim import (
    AdamW,
    Grads,
    MaskedMultiSteps,
    make_optimizer,
)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: AdamW
    accumulator: Optional[MaskedMultiSteps] = None
    step: int = 0                     # micro-steps taken
    mesh: Optional[object] = None     # the model's tp_mesh

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainConfig, total_steps: int, *,
               freeze_roberta_body: bool = False) -> "TrainState":
        """The state of ``model``, sharded or not: a model that
        ``shard_module_`` split brings its mesh and the names of its split
        parameters (the clipping norm's)."""
        optimizer, accumulator = make_optimizer(
            cfg, total_steps, model, freeze_roberta_body=freeze_roberta_body)
        mesh = getattr(model, "tp_mesh", None)
        if mesh is not None:
            from multimodal_context_reasoning_torch.parallel.mesh import axis_group

            optimizer.shard(model.tp_plan, axis_group(mesh, "model"))
        return cls(model=model, optimizer=optimizer, accumulator=accumulator, mesh=mesh)

    def apply_gradients(self, grads: Grads) -> None:
        """One micro-step: accumulate, and update when the window closes."""
        if self.accumulator is not None:
            grads = self.accumulator.update(grads)
        if grads is not None:
            self.optimizer.update(grads)
        self.step += 1

    def opt_state_dict(self) -> Dict:
        state = {"optimizer": self.optimizer.state_dict()}
        if self.accumulator is not None:
            state["accumulator"] = self.accumulator.state_dict()
        return state

    def load_opt_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.accumulator is not None:
            self.accumulator.load_state_dict(state["accumulator"])
