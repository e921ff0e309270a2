"""Collectives of the tensor-parallel layers and the data-parallel step.

Every collective on the port's path is an all-reduce or a broadcast:
NCCL refuses two ranks on one GPU, and gloo, which can share one, has no
all-gather of CUDA tensors.  A gather is therefore an all-reduce of a
zero buffer that each rank has filled at its own place (exact: x + 0 = x).

A group of one rank, or ``None``, is no collective at all, so a mesh of one
process computes exactly what the mesh-less code computes.

The two autograd Functions are Megatron-LM's pair around a column- then
row-parallel product: :func:`copy_to_group` is the identity forward with
an all-reduce backward (each rank's input gradient covers only its output
columns), :func:`reduce_from_group` the all-reduce forward (each rank
holds a partial sum over its input rows) with the identity backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks in ``group``; 1 for ``None``."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (nothing for one rank)."""
    if group_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``group``."""
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward, identity backward."""
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_rows(local: torch.Tensor, index: int, group) -> torch.Tensor:
    """The blocks of rows of every rank of ``group`` stacked in rank order
    (each rank gives ``local`` of one shape, ``index`` its place)."""
    n = group_size(group)
    if n == 1:
        return local
    full = local.new_zeros((n * local.shape[0],) + tuple(local.shape[1:]))
    full[index * local.shape[0]:(index + 1) * local.shape[0]] = local
    return all_reduce_(full, group)


def comm_device() -> torch.device:
    """Where a small bookkeeping tensor of the default process group lives:
    the current card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
