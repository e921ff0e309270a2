"""Indexed binary region-feature store: writer and reader (a copy of the
JAX package's ``data/feature_store.py`` without its native reader).

The replacement for the reference's load-the-whole-pickle feature dict
(Data/VCRChunkAlign.py:778-781), in the ``.mcrpack`` format that
``native/feature_store.cpp`` documents: a header, a table of entries sorted
by the FNV-1a hash of their keys, the keys, then each image's
[n_regions, dim] float32 rows at a 64-byte aligned offset.

- :func:`write_pack` - offline packer (numpy -> .mcrpack).
- :class:`FeatureStore` - reader over ``mmap`` and ``struct`` in Python.
  The JAX package also has a zero-copy reader in C++
  (``native/libmcr_feature_store.so``); the port does not load it yet, so
  every lookup here copies its rows out of the mapping.  It implements the
  mapping protocol ``PMRDataset`` consumes (``key in store``,
  ``store[key]``).
"""

from __future__ import annotations

import mmap
import struct
from typing import Dict, Optional

import numpy as np

from multimodal_context_reasoning_torch.data.schemas import ImageFeatures

MAGIC = 0x4652434D  # 'MCRF'
VERSION = 1
_HEADER = struct.Struct("<IIQII")          # magic, version, n, dim, pad
_ENTRY = struct.Struct("<QQIIQ")           # hash, key_off, key_len, n_regions, data_off
_ALIGN = 64


def _fnv1a(data: bytes) -> int:
    h = 1469598103934665603
    for b in data:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def write_pack(features: Dict[str, np.ndarray], path: str) -> None:
    """Pack {key: [n_regions, dim] float32} into an .mcrpack file."""
    items = [(k.encode(), np.ascontiguousarray(v, np.float32))
             for k, v in features.items()]
    if not items:
        raise ValueError("empty feature dict")
    dim = items[0][1].shape[1]
    for k, v in items:
        if v.ndim != 2 or v.shape[1] != dim:
            raise ValueError(f"{k!r}: inconsistent shape {v.shape}")

    entries = sorted(
        ((_fnv1a(k), k, v) for k, v in items), key=lambda e: e[0]
    )
    n = len(entries)
    keys_off = _HEADER.size + n * _ENTRY.size
    key_offsets = []
    off = keys_off
    for _, k, _v in entries:
        key_offsets.append(off)
        off += len(k)
    data_start = (off + _ALIGN - 1) // _ALIGN * _ALIGN
    data_offsets = []
    off = data_start
    for _, _k, v in entries:
        data_offsets.append(off)
        off += v.nbytes
        off = (off + _ALIGN - 1) // _ALIGN * _ALIGN

    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION, n, dim, 0))
        for (h, k, v), ko, do in zip(entries, key_offsets, data_offsets):
            f.write(_ENTRY.pack(h, ko, len(k), v.shape[0], do))
        for _, k, _v in entries:
            f.write(k)
        for (_, _k, v), do in zip(entries, data_offsets):
            f.seek(do)
            f.write(v.tobytes())


class _PyReader:
    """The .mcrpack format in Python (mmap + struct)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, n, dim, _ = _HEADER.unpack_from(self._mm, 0)
        if magic != MAGIC or version != VERSION:
            raise IOError(f"bad pack file {path}")
        self.count, self.dim = n, dim
        self._index = {}
        off = _HEADER.size
        for _ in range(n):
            h, ko, kl, nr, do = _ENTRY.unpack_from(self._mm, off)
            key = self._mm[ko:ko + kl].decode()
            self._index[key] = (nr, do)
            off += _ENTRY.size

    def keys(self):
        return iter(self._index)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def lookup(self, key: str) -> Optional[np.ndarray]:
        hit = self._index.get(key)
        if hit is None:
            return None
        nr, do = hit
        # copy: a zero-copy view would pin the mmap open past close()
        return np.frombuffer(
            self._mm, np.float32, count=nr * self.dim, offset=do
        ).reshape(nr, self.dim).copy()

    def close(self):
        self._mm.close()
        self._f.close()


class FeatureStore:
    """Mapping-protocol reader over an .mcrpack file (the Python reader)."""

    def __init__(self, path: str):
        self._reader = _PyReader(path)

    @property
    def dim(self) -> int:
        return self._reader.dim

    def keys(self):
        return self._reader.keys()

    def __len__(self) -> int:
        return self._reader.count

    def __contains__(self, key: str) -> bool:
        return key in self._reader

    def __getitem__(self, key: str) -> ImageFeatures:
        feats = self._reader.lookup(key)
        if feats is None:
            raise KeyError(key)
        return ImageFeatures(features=feats, num_regions=feats.shape[0])

    def close(self) -> None:
        self._reader.close()
