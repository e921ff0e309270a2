"""Multi-process data ingestion (port of the JAX package's
``parallel/multihost.py``).

The JAX program spans every process and needs global arrays, so its
``global_batch`` lifts each process's rows into one array sharded over the
``data`` axis, and ``_lift_replicated`` lifts the device-resident feature
table replicated.  In the port each rank runs its own step on its own rows
(the loader's ``shard=(data index, data size)``, or
``partition.local_rows``), so the rows need no lift.  What is left is the
table: every rank gathers its examples' regions from its own copy, and
copies that differ would be wrong without an error.  :func:`check_replicated`
compares a position-sensitive digest of each copy (CRC32 over the raw
bytes, and the shape) across all ranks and raises the JAX package's
``ValueError`` on every rank when they differ (a permutation-invariant sum
would miss the likeliest divergence: the same features under another key
order, rows permuted).  ``DeviceFeatureTable.place`` runs it once per
table.
"""

from __future__ import annotations

import zlib

import torch
import torch.distributed as dist

from multimodal_context_reasoning_torch.parallel.comm import all_reduce_, comm_device

_MAX_DIMS = 4


def digest(t: torch.Tensor) -> torch.Tensor:
    """float64 [1 + 4]: CRC32 of ``t``'s bytes, then its shape (zero-padded)."""
    raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
    if t.dim() > _MAX_DIMS:
        raise ValueError(f"a digest covers up to {_MAX_DIMS} dims, got {tuple(t.shape)}")
    shape = list(t.shape) + [0] * (_MAX_DIMS - t.dim())
    return torch.tensor([zlib.crc32(raw), *shape], dtype=torch.float64)


def check_replicated(t: torch.Tensor, name: str) -> None:
    """Raise ``ValueError`` on every rank unless every rank of the world
    holds the same ``t`` (no check without a process group)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    mine = digest(t)
    table = torch.zeros((world, mine.numel()), dtype=torch.float64, device=comm_device())
    table[rank] = mine.to(table.device)
    digests = all_reduce_(table, dist.group.WORLD).cpu()
    if not bool((digests == digests[0]).all()):
        raise ValueError(
            f"device-table batch key {name!r} differs across hosts "
            f"(digests {digests.tolist()}); every process must build its "
            "DeviceFeatureTable from the same image-feature dict"
        )

