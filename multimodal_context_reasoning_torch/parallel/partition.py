"""Parameter and batch partition rules (port of the JAX package's
``parallel/partition.py``).

The rules are the JAX package's ``PARAM_RULES`` under the port's parameter
names, in the reference layout (``nn.Linear.weight`` is [out, in], the
vendored GPT-2 ``Conv1D.weight`` [in, out]).  They split along the
``model`` axis:

- column-parallel layers hold a block of output features: the attention
  queries, keys and values (``attention.self.{query,key,value}``, the
  fusion's ``cross_attention.{q,k,v}_proj``, GPT-2's ``c_attn`` and
  ``q_attn``) and the FFN's first product (``intermediate.dense``, GPT-2's
  ``mlp.c_fc``).  Weight and bias are split;
- row-parallel layers hold a block of input features: the attention
  outputs (``attention.output.dense``, ``cross_attention.out_proj``,
  GPT-2's ``attn.c_proj`` and ``crossattention.c_proj``) and the FFN's
  second product (``output.dense``, GPT-2's ``mlp.c_proj``).  The weight is
  split; the bias is whole and added once, after the sum over the group;
- everything else is replicated, as in the JAX package (which also keeps
  the column-parallel biases whole: XLA slices them in the program).

GPT-2's fused ``c_attn`` ([D, 3D], and the cross-attention's [D, 2D]) is
split per q / k / v part, so each rank holds its heads of each.

:func:`shard_module_` slices a model's parameters in place and tells each
split layer its group (the forward then runs Megatron-LM's pair of
collectives, parallel/comm.py).  :func:`gather_state_dict` rebuilds the
full reference-layout state dict, so a checkpoint saved under any mesh
loads into a model of any other with ``strict=True``;
:func:`shard_state_dict` slices one for the current mesh.  :func:`local_rows`
is ``batch_shardings``: each data index takes the contiguous block of rows
that JAX's ``P("data")`` gives it, the device-table keys stay whole.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from multimodal_context_reasoning_torch.data.device_table import TABLE_KEYS
from multimodal_context_reasoning_torch.parallel.comm import all_reduce_
from multimodal_context_reasoning_torch.parallel.mesh import axis_group, axis_index, axis_size

COL, ROW = "col", "row"

# (regex over the "."-joined module path of a Linear or Conv1D, kind) — the
# first match wins; no match is replicated
PARAM_RULES: Tuple[Tuple[str, str], ...] = (
    (r".*attention\.self\.(query|key|value)", COL),
    (r".*attention\.output\.dense", ROW),
    (r".*cross_attention\.(q_proj|k_proj|v_proj)", COL),
    (r".*cross_attention\.out_proj", ROW),
    (r".*intermediate\.dense", COL),
    (r".*output\.dense", ROW),
    (r".*(attn|crossattention)\.(c_attn|q_attn)", COL),
    (r".*(attn|crossattention)\.c_proj", ROW),
    (r".*mlp\.c_fc", COL),
    (r".*mlp\.c_proj", ROW),
)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A tensor split over the model axis along ``dim``, each of its
    ``parts`` equal parts (fused q / k / v) split separately."""

    dim: int
    parts: int = 1


def layer_kind(module_path: str) -> Optional[str]:
    """``COL``, ``ROW`` or ``None`` (replicated) for a layer's path."""
    for pattern, kind in PARAM_RULES:
        if re.fullmatch(pattern, module_path):
            return kind
    return None


def _fused_parts(module_path: str) -> int:
    if module_path.endswith("crossattention.c_attn"):
        return 2
    if module_path.endswith("attn.c_attn"):
        return 3
    return 1


def plan_for(model: nn.Module) -> Tuple[Dict[str, Shard], Dict[str, str]]:
    """(parameter name -> :class:`Shard` for every split parameter, module
    path -> kind for every split layer) of ``model``."""
    from multimodal_context_reasoning_torch.models.gpt2 import Conv1D
    from multimodal_context_reasoning_torch.models.layers import Linear

    params: Dict[str, Shard] = {}
    layers: Dict[str, str] = {}
    for path, mod in model.named_modules():
        if not isinstance(mod, (Linear, Conv1D)):
            continue
        kind = layer_kind(path)
        if kind is None:
            continue
        layers[path] = kind
        # torch Linear is [out, in]; Conv1D [in, out]
        out_dim = 0 if isinstance(mod, Linear) else 1
        parts = _fused_parts(path) if isinstance(mod, Conv1D) else 1
        if kind == COL:
            params[f"{path}.weight"] = Shard(out_dim, parts)
            params[f"{path}.bias"] = Shard(0, parts)
        else:
            params[f"{path}.weight"] = Shard(1 - out_dim)
    return params, layers


def _check_heads(model: nn.Module, m: int) -> None:
    from multimodal_context_reasoning_torch.models.fusion import ClsLayerLyx
    from multimodal_context_reasoning_torch.models.gpt2 import (
        GPT2Attention,
        GPT2CrossAttention,
    )
    from multimodal_context_reasoning_torch.models.layers import SelfAttention

    for path, mod in model.named_modules():
        if isinstance(mod, SelfAttention):
            heads = mod.config.num_attention_heads
        elif isinstance(mod, ClsLayerLyx):
            heads = mod.num_heads
        elif isinstance(mod, (GPT2Attention, GPT2CrossAttention)):
            heads = mod.config.n_head
        else:
            continue
        if heads % m:
            raise ValueError(f"{path}: {heads} attention heads are not divisible by "
                             f"the mesh's model axis ({m})")


def _slice(t: torch.Tensor, shard: Shard, m: int, r: int) -> torch.Tensor:
    parts = t.chunk(shard.parts, shard.dim)
    return torch.cat([p.chunk(m, shard.dim)[r] for p in parts], shard.dim).contiguous()


def _check_divisible(name: str, t: torch.Tensor, shard: Shard, m: int) -> None:
    if t.shape[shard.dim] % (shard.parts * m):
        raise ValueError(f"{name}: dim {shard.dim} of shape {tuple(t.shape)} does not "
                         f"split into {shard.parts} x {m} equal blocks")


def shard_module_(model: nn.Module, mesh) -> nn.Module:
    """Slice ``model``'s split parameters to this rank's block of the model
    axis, in place, and set each split layer's group; returns ``model``.

    The model records ``tp_plan`` (parameter name -> :class:`Shard`) and
    ``tp_mesh``.  Over a model axis of one rank nothing is sliced and no
    layer gets a group: the forward is the mesh-less one.  Build optimizer
    state after this call: the parameters are new tensors."""
    from multimodal_context_reasoning_torch.models.layers import SelfAttention

    if getattr(model, "tp_plan", None) is not None:
        raise ValueError("the model is already sharded")
    plan, layers = plan_for(model)
    m, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    group = axis_group(mesh, "model")
    if m > 1:
        _check_heads(model, m)
        named = dict(model.named_parameters())
        for name, shard in plan.items():
            _check_divisible(name, named[name], shard, m)
        mods = dict(model.named_modules())
        with torch.no_grad():
            for name, shard in plan.items():
                path, leaf = name.rsplit(".", 1)
                old = named[name]
                new = nn.Parameter(_slice(old.detach(), shard, m, r),
                                   requires_grad=old.requires_grad)
                setattr(mods[path], leaf, new)
        for path, kind in layers.items():
            mods[path].tp_mode, mods[path].tp_group = kind, group
        for mod in model.modules():
            if isinstance(mod, SelfAttention):
                mod.head_group = group
    model.tp_plan = plan
    model.tp_mesh = mesh
    return model


def gather_tensor(local: torch.Tensor, shard: Shard, mesh) -> torch.Tensor:
    """The full tensor of which ``local`` is this rank's block (an
    all-reduce of a zero buffer filled at this rank's place)."""
    m = axis_size(mesh, "model")
    if m == 1:
        return local
    shape = list(local.shape)
    shape[shard.dim] *= m
    full = local.new_zeros(shape)
    r = axis_index(mesh, "model")
    for whole, mine in zip(full.chunk(shard.parts, shard.dim),
                           local.chunk(shard.parts, shard.dim)):
        whole.chunk(m, shard.dim)[r].copy_(mine)
    return all_reduce_(full, axis_group(mesh, "model"))


def gather_named(tensors: Mapping[str, torch.Tensor], model: nn.Module
                 ) -> Dict[str, torch.Tensor]:
    """Parameter-named tensors (a state dict, AdamW moments, an
    accumulator) of a sharded ``model`` -> full tensors on the CPU."""
    plan = getattr(model, "tp_plan", None) or {}
    mesh = getattr(model, "tp_mesh", None)
    return {k: (gather_tensor(v.detach(), plan[k], mesh) if k in plan else v.detach()).cpu()
            for k, v in tensors.items()}


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full reference-layout state dict of a sharded (or unsharded)
    ``model``, on the CPU; every rank of its model group must call it."""
    return gather_named(model.state_dict(), model)


def shard_state_dict(state: Mapping[str, torch.Tensor], model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """Full parameter-named tensors -> this rank's blocks for ``model``'s
    mesh (the inverse of :func:`gather_named`)."""
    plan = getattr(model, "tp_plan", None) or {}
    mesh = getattr(model, "tp_mesh", None)
    m, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    if m == 1:
        return dict(state)
    return {k: _slice(v, plan[k], m, r) if k in plan else v for k, v in state.items()}


def local_rows(batch: Mapping[str, torch.Tensor], mesh) -> Dict:
    """This data index's contiguous block of every batch array's leading
    axis (JAX's ``P("data")`` layout); the device-table keys stay whole."""
    n, d = axis_size(mesh, "data"), axis_index(mesh, "data")
    if n == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if k in TABLE_KEYS:
            out[k] = v
            continue
        rows = v.shape[0]
        if rows % n:
            raise ValueError(f"batch key {k!r}: {rows} rows do not split over the "
                             f"mesh's data axis ({n})")
        out[k] = v[d * (rows // n):(d + 1) * (rows // n)]
    return out
