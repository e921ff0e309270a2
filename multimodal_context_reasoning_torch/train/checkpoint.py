"""Checkpoints with ``torch.save`` (port of the JAX package's
``train/checkpoint.py``, which uses Orbax).

One directory per saved micro-step, ``<directory>/<step>/``, holding
``state.pt`` (the fp32 parameters as the port's state dict, the step and,
unless ``params_only``, the optimizer and accumulator state) and
``metrics.json``.  A save is written to a temporary directory and renamed
into place, so a crash never leaves a half-written step behind.  The
``max_to_keep`` checkpoints of highest ``accuracy`` stay, as Orbax's
``best_fn`` / ``best_mode="max"`` keeps them.  A ``params_only`` manager
refuses :meth:`restore`: its checkpoints hold no optimizer state to resume
from.

On a mesh (``TrainState.mesh``) a checkpoint holds the whole model in the
reference layout, whatever the mesh: :meth:`CheckpointManager.save` gathers
the parameters and the optimizer's per-parameter state over the model
group (parallel/partition.py), rank 0 writes, and every rank waits at a
barrier; :meth:`CheckpointManager.restore` slices what it reads for the
state's mesh, so a run resumes on another topology.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from multimodal_context_reasoning_torch.parallel.partition import gather_named, shard_state_dict
from multimodal_context_reasoning_torch.train.state import TrainState

# the optimizer and accumulator entries keyed by parameter name
_NAMED = ("mu", "nu", "acc")


def _map_named(tree, fn):
    """``tree`` (an opt_state_dict) with ``fn`` applied to each
    parameter-named dict of tensors; other tensors to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: fn(v) if k in _NAMED else _map_named(v, fn) for k, v in tree.items()}
    return tree


def _distributed(state: TrainState) -> bool:
    return (getattr(state, "mesh", None) is not None and dist.is_available()
            and dist.is_initialized())


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3, params_only: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.params_only = params_only
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.exists(os.path.join(self._path(int(name)), "state.pt")))

    def _metric(self, step: int) -> float:
        with open(os.path.join(self._path(step), "metrics.json")) as f:
            return float(json.load(f).get("accuracy", 0.0))

    def save(self, state: TrainState, metrics: Optional[dict] = None) -> None:
        """Write step ``state.step``; on a mesh every rank calls it."""
        step = int(state.step)
        model = state.model
        payload: Dict[str, Any] = {
            "params": gather_named(model.state_dict(), model),
            "step": step,
        }
        if not self.params_only:
            payload["opt_state"] = _map_named(state.opt_state_dict(),
                                              lambda d: gather_named(d, model))
        if _distributed(state):
            if dist.get_rank() == 0:
                self._write(step, payload, metrics)
            dist.barrier()
        else:
            self._write(step, payload, metrics)

    def _write(self, step: int, payload: Dict[str, Any], metrics: Optional[dict]) -> None:
        tmp = self._path(step) + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save(payload, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        if os.path.exists(self._path(step)):
            shutil.rmtree(self._path(step))
        os.replace(tmp, self._path(step))
        self._prune()

    def _prune(self) -> None:
        steps = sorted(self.all_steps(), key=lambda s: (self._metric(s), s))
        for step in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(self._path(step))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        steps = self.all_steps()
        if not steps:
            return None
        return max(steps, key=lambda s: (self._metric(s), s))

    def _load(self, step: int) -> Dict[str, Any]:
        return torch.load(os.path.join(self._path(step), "state.pt"), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load parameters, optimizer state and step into ``state`` in place
        (tensors keep their devices); returns it."""
        if self.params_only:
            raise ValueError(
                "this manager saves params-only checkpoints (no opt_state); "
                "training cannot resume from them - use restore_params()")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        payload = self._load(step)
        model = state.model
        state.model.load_state_dict(shard_state_dict(payload["params"], model), strict=True)
        state.load_opt_state_dict(_map_named(payload["opt_state"],
                                             lambda d: shard_state_dict(d, model)))
        state.step = int(payload["step"])
        return state

    def restore_params(self, step: Optional[int] = None, *,
                       best: bool = False) -> Dict[str, torch.Tensor]:
        """The saved parameters as a CPU state dict; ``best=True`` takes the
        best-accuracy step (the reference deploys its best save), falling
        back to the latest."""
        if step is None:
            step = self.best_step() if best else None
            if step is None:
                step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return self._load(step)["params"]


def save_config(directory: str, name: str, payload: Any) -> None:
    """Dump a JSON sidecar (replaces training_args.bin, run_PMR_ModCR.py:79)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, name), "w") as f:
        if hasattr(payload, "to_json"):
            f.write(payload.to_json())
        else:
            json.dump(payload, f, indent=2, default=str)
