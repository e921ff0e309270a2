"""Optimizer and LR schedule (port of the JAX package's ``train/optim.py``).

The reference's recipe (run_PMR_ModCR.py:127-145), with optax's arithmetic:

- parameters are labelled by name (:func:`label_params`): ``frozen`` (the two
  encoders under ``freeze_encoders``, RoBERTa's body under
  ``freeze_roberta_body``), ``seq`` (``seq_enc`` at ``lr * seq_enc_lr_scale``)
  or ``main``; frozen parameters get no optimizer state and no update;
- :func:`make_schedule` is optax's ``linear_schedule`` / ``join_schedules``:
  the LR factor of update ``n`` (counting from 0) is ``schedule(n)``, and the
  decay takes over at ``n >= warmup_steps``;
- :class:`AdamW` clips by global norm first, as ``optax.clip_by_global_norm``
  does (``g / norm * max_norm`` when ``norm >= max_norm``, with no 1e-6 as in
  ``clip_grad_norm_``), then runs optax's AdamW on each group:
  ``m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps)``, eps outside the square
  root, weight decay masked off biases and LayerNorm when it is non-zero;
- :class:`MaskedMultiSteps` is ``masked_multisteps`` (optim.py:35-106): a
  running-mean accumulator for the trainable parameters only, emitting an
  update every ``k`` micro-steps.

Updates run in place under ``torch.no_grad`` with ``torch._foreach_*`` ops,
one launch per operation over a group's tensors.

Under tensor parallelism (:meth:`AdamW.shard`) the clipping norm sums the
squares of the split parameters' gradients over the model group and counts
each replicated gradient once (:func:`sharded_global_norm`), so it is the
norm of the whole model's gradient, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.core.config import TrainConfig
from multimodal_context_reasoning_torch.parallel.comm import all_reduce_, group_size

Grads = Dict[str, Optional[torch.Tensor]]


def _linear_schedule(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps`` counts, then flat."""
    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def make_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """Linear warmup, then linear-decay-to-zero or constant."""
    if cfg.scheduler == "constant":
        if cfg.warmup_steps > 0:
            return _linear_schedule(0.0, 1.0, cfg.warmup_steps)
        return lambda count: 1.0
    if cfg.scheduler == "linear":
        warm = _linear_schedule(0.0, 1.0, max(cfg.warmup_steps, 1))
        decay = _linear_schedule(1.0, 0.0, max(total_steps - cfg.warmup_steps, 1))
        boundary = cfg.warmup_steps
        return lambda count: (warm(count) if count < boundary
                              else decay(count - boundary))
    raise ValueError(f"Unknown scheduler type: {cfg.scheduler}")


def label_params(names: Iterable[str], *, freeze_encoders: bool = True,
                 freeze_roberta_body: bool = False) -> Dict[str, str]:
    """Name -> 'main' | 'seq' (lr x seq_enc_lr_scale) | 'frozen', the
    name-substring grouping of run_PMR_ModCR.py:127-135 under the freezing
    rules (run_vcr_ModCR.py:783-787 for the RoBERTa body)."""

    def label(name: str) -> str:
        if freeze_encoders and ("global_enc" in name or "seq_enc" in name):
            return "frozen"
        if freeze_roberta_body and "roberta" in name:
            if "embeddings" not in name and "pooler" not in name:
                return "frozen"
        if "seq_enc" in name:
            return "seq"
        return "main"

    return {name: label(name) for name in names}


def _is_decayed(name: str, p: torch.Tensor) -> bool:
    """The JAX decay mask: no decay on biases, LayerNorm or any vector."""
    return not (name.endswith(".bias") or "LayerNorm" in name or "layer_norm" in name
                or p.dim() <= 1)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of ``tensors``
    (``optax.global_norm``).  CUDA tensors take one fused ``_foreach_norm``.
    On the CPU PyTorch's fp32 vector norm accumulates sequentially and is
    off by about 4e-4 relative at 10M elements, so the squares are summed
    by ``sum``, which sums in a cascade."""
    if tensors[0].device.type == "cuda":
        return torch.stack(torch._foreach_norm(tensors)).norm()
    return torch.stack([t.square().sum() for t in tensors]).sum().sqrt()


def sharded_global_norm(grads: Grads, sharded=(), group=None) -> torch.Tensor:
    """:func:`global_norm` of every gradient in ``grads`` where the names in
    ``sharded`` are this rank's blocks of tensors split over ``group``: their
    squares are summed over the group, the others counted once."""
    given = [g for g in grads.values() if g is not None]
    if group_size(group) == 1:
        return global_norm(given)
    split = [g for n, g in grads.items() if g is not None and n in sharded]
    whole = [g for n, g in grads.items() if g is not None and n not in sharded]
    sq = torch.zeros((), device=given[0].device)
    if split:
        sq = global_norm(split).square()
    sq = all_reduce_(sq, group)
    if whole:
        sq = sq + global_norm(whole).square()
    return sq.sqrt()


class AdamW:
    """``chain(clip_by_global_norm, multi_transform(adamw per group))`` over a
    model's named parameters; see the module docstring."""

    def __init__(self, params: Dict[str, nn.Parameter], labels: Dict[str, str],
                 cfg: TrainConfig, total_steps: int):
        self.cfg = cfg
        self.schedule = make_schedule(cfg, total_steps)
        self.count = 0
        scales = {"main": 1.0, "seq": cfg.seq_enc_lr_scale}
        self.groups = []
        for label, scale in scales.items():
            names = [n for n in params if labels[n] == label]
            if names:
                self.groups.append(dict(names=names, scale=scale,
                                        decayed=[n for n in names
                                                 if _is_decayed(n, params[n])]))
        self.params = {n: params[n] for g in self.groups for n in g["names"]}
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.sharded, self.group = frozenset(), None

    def shard(self, sharded, group) -> None:
        """The parameter names split over the model ``group``, for the
        clipping norm (parallel/partition.py)."""
        self.sharded, self.group = frozenset(sharded), group

    def global_norm(self, grads: Grads) -> torch.Tensor:
        """The whole model's gradient norm (:func:`sharded_global_norm`)."""
        return sharded_global_norm(grads, self.sharded, self.group)

    @torch.no_grad()
    def update(self, grads: Grads) -> None:
        """One optimizer update from ``grads`` (name -> gradient; a missing
        or None entry is a zero gradient).  The clipping norm is taken over
        every gradient given, frozen parameters' included, as optax takes it
        over the whole tree."""
        cfg = self.cfg
        names = [n for n in self.params if grads.get(n) is not None]
        gs = [grads[n] for n in names]
        if gs:
            norm = self.global_norm(grads)
            keep = norm < cfg.max_grad_norm
            # optax: select(norm < max, g, (g / norm) * max), without a host sync
            torch._foreach_div_(gs, torch.where(keep, torch.ones_like(norm), norm))
            torch._foreach_mul_(gs, torch.where(keep, torch.ones_like(norm),
                                                torch.full_like(norm, cfg.max_grad_norm)))
        clipped = dict(zip(names, gs))
        t = self.count + 1
        bc1, bc2 = 1.0 - cfg.adam_b1 ** t, 1.0 - cfg.adam_b2 ** t
        factor = self.schedule(self.count)
        for group in self.groups:
            ns = group["names"]
            g = [clipped[n] if n in clipped else torch.zeros_like(self.params[n]) for n in ns]
            mu, nu, p = ([self.mu[n] for n in ns], [self.nu[n] for n in ns],
                         [self.params[n] for n in ns])
            torch._foreach_mul_(mu, cfg.adam_b1)
            torch._foreach_add_(mu, g, alpha=1.0 - cfg.adam_b1)
            torch._foreach_mul_(nu, cfg.adam_b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - cfg.adam_b2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.adam_epsilon)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            if cfg.weight_decay != 0.0 and group["decayed"]:
                idx = [ns.index(n) for n in group["decayed"]]
                torch._foreach_add_([upd[i] for i in idx], [p[i] for i in idx],
                                    alpha=cfg.weight_decay)
            lr = cfg.learning_rate * group["scale"] * factor
            torch._foreach_add_(p, upd, alpha=-lr)
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            for n, t in getattr(self, key).items():
                t.copy_(state[key][n])


class MaskedMultiSteps:
    """Gradient accumulation over ``every_k`` micro-steps for the trainable
    parameters only (frozen ones store nothing): the running mean
    ``acc += (g - acc) / (k + 1)`` of ``optax.MultiSteps(use_grad_mean=True)``,
    emitted at the window's last micro-step and then reset."""

    def __init__(self, params: Dict[str, nn.Parameter], every_k: int):
        self.every_k = every_k
        self.mini_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def update(self, grads: Grads) -> Optional[Grads]:
        """Fold ``grads`` in; return the window's mean gradients when this
        micro-step closes the window, else None."""
        k = self.mini_step
        for n, a in self.acc.items():
            g = grads.get(n)
            g = torch.zeros_like(a) if g is None else g
            a.add_((g - a) / float(k + 1))
        self.mini_step = (k + 1) % self.every_k
        if self.mini_step != 0:
            return None
        mean = {n: a.clone() for n, a in self.acc.items()}
        for a in self.acc.values():
            a.zero_()
        return mean

    def state_dict(self) -> Dict:
        return {"mini_step": self.mini_step, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.mini_step = int(state["mini_step"])
        for n, t in self.acc.items():
            t.copy_(state["acc"][n])


def make_optimizer(cfg: TrainConfig, total_steps: int, model: nn.Module, *,
                   freeze_roberta_body: bool = False
                   ) -> Tuple[AdamW, Optional[MaskedMultiSteps]]:
    """The optimizer of ``model``'s named parameters and, when
    ``gradient_accumulation_steps > 1``, its accumulator."""
    params = dict(model.named_parameters())
    labels = label_params(params, freeze_encoders=cfg.freeze_encoders,
                          freeze_roberta_body=freeze_roberta_body)
    opt = AdamW(params, labels, cfg, total_steps)
    acc = None
    if cfg.gradient_accumulation_steps > 1:
        acc = MaskedMultiSteps(opt.params, cfg.gradient_accumulation_steps)
    return opt, acc
