"""Device-mesh construction (port of the JAX package's ``parallel/mesh.py``).

The mesh axes are ``("data", "model")`` over one process per device: the
data axis averages gradients and splits each batch into contiguous blocks
of rows, the model axis splits attention heads and FFN neurons
(parallel/partition.py).  Rank ``r`` sits at data index ``r // model`` and
model index ``r % model``, so the ranks of one model group are consecutive
and share a data index.  The mesh is a ``torch.distributed`` ``DeviceMesh``
over the process group the caller initialised (``torchrun`` and
``--multihost``, or ``init_process_group`` by hand); it never starts one
itself, and a mesh that does not cover exactly the world is an error.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")


def mesh_shape_for(num_devices: int, model_parallelism: int = 1) -> Tuple[int, int]:
    """(data, model) factorization of ``num_devices``."""
    if num_devices % model_parallelism != 0:
        raise ValueError(
            f"{num_devices} devices not divisible by model_parallelism="
            f"{model_parallelism}"
        )
    return num_devices // model_parallelism, model_parallelism


def make_mesh(shape: Optional[Tuple[int, int]] = None, *,
              model_parallelism: int = 1) -> DeviceMesh:
    """A ("data", "model") mesh over the initialised process group.

    With ``shape=None`` every process goes to the data axis except for
    ``model_parallelism``-way tensor sharding."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"a ('data', 'model') mesh of shape {shape or ('?', model_parallelism)} "
            "needs an initialised torch.distributed process group (launch with "
            "torchrun and --multihost, or call init_process_group first)")
    world = dist.get_world_size()
    if shape is None:
        shape = mesh_shape_for(world, model_parallelism)
    d, m = (int(s) for s in shape)
    if d * m != world:
        raise ValueError(f"mesh shape {tuple(shape)} != {world} processes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (d, m), mesh_dim_names=AXES)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """Size of ``axis``; 1 without a mesh."""
    return 1 if mesh is None else mesh.shape[AXES.index(axis)]


def axis_index(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate on ``axis``; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(AXES.index(axis))


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group along ``axis`` through this rank; ``None``
    (no collective) without a mesh or for an axis of one rank."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(AXES.index(axis))
