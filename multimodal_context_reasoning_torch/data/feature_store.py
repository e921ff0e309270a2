"""Indexed binary region-feature store: writer and readers (port of the
JAX package's ``data/feature_store.py``).

The replacement for the reference's load-the-whole-pickle feature dict
(Data/VCRChunkAlign.py:778-781), in the ``.mcrpack`` format that
``native/feature_store.cpp`` documents: a header, a table of entries sorted
by the FNV-1a hash of their keys, the keys, then each image's
[n_regions, dim] float32 rows at a 64-byte aligned offset.

- :func:`write_pack` - offline packer (numpy -> .mcrpack).
- :class:`FeatureStore` - reader.  It loads the C++ mmap library through
  ``ctypes`` for zero-copy O(log n) lookups: read-only views into the
  mapping that pin their reader.  The library is the committed
  ``native/libmcr_feature_store.so`` when it loads on this machine, else
  one built from ``native/feature_store.cpp`` with ``native/Makefile``'s
  flags into ``build/native/`` (:func:`native_library`).  Only when there
  is no library at all does it fall back to the Python reader of the same
  format, which copies each lookup; a library that is there but fails is
  an error.  It implements the mapping protocol ``PMRDataset`` consumes
  (``key in store``, ``store[key]``).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import shutil
import struct
import subprocess
from pathlib import Path
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


REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO / "native"
NATIVE_BUILD_DIR = REPO / "build" / "native"
_LIB = "libmcr_feature_store.so"
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O2", "-Wall", "-Wextra", "-std=c++17", "-fPIC")


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.mcr_open.restype = ctypes.c_void_p
    lib.mcr_open.argtypes = [ctypes.c_char_p]
    lib.mcr_close.argtypes = [ctypes.c_void_p]
    lib.mcr_count.restype = ctypes.c_uint64
    lib.mcr_count.argtypes = [ctypes.c_void_p]
    lib.mcr_dim.restype = ctypes.c_uint32
    lib.mcr_dim.argtypes = [ctypes.c_void_p]
    lib.mcr_lookup.restype = ctypes.POINTER(ctypes.c_float)
    lib.mcr_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                               ctypes.POINTER(ctypes.c_uint32)]
    lib.mcr_key_at.restype = ctypes.c_void_p
    lib.mcr_key_at.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                               ctypes.POINTER(ctypes.c_uint32)]
    return lib


def _build_native() -> str:
    """Build the library from ``native/feature_store.cpp`` into
    ``build/native/``; raises ``RuntimeError`` with the compiler's output."""
    out = NATIVE_BUILD_DIR / _LIB
    src = NATIVE_DIR / "feature_store.cpp"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return str(out)
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler to build {src}")
    NATIVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    run = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{run.stdout}{run.stderr}")
    os.replace(tmp, out)
    return str(out)


def native_library() -> Optional[ctypes.CDLL]:
    """The C++ reader library, or None when there is none: the committed
    ``native/libmcr_feature_store.so`` if it loads here, else one built from
    ``native/feature_store.cpp`` (``build/native/``, rebuilt only when the
    source is newer).  A library that is present but neither loads nor
    builds raises."""
    committed, src = NATIVE_DIR / _LIB, NATIVE_DIR / "feature_store.cpp"
    if not committed.exists() and not src.exists():
        return None
    try:
        return _bind(str(committed))
    except OSError as e:
        if not src.exists():
            raise
        try:
            return _bind(_build_native())
        except (OSError, RuntimeError) as built:
            raise RuntimeError(f"{committed} does not load ({e}) and building it from "
                               f"{src} failed: {built}") from built


class _MappedView(np.ndarray):
    """ndarray view subclass carrying a reference to its mmap owner."""

    _mcr_reader = None


class _NativeReader:
    """The C++ reader (``native/feature_store.cpp``) over ``ctypes``."""

    def __init__(self, path: str, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.mcr_open(path.encode())
        if not self._h:
            raise IOError(f"mcr_open failed for {path}")
        self.dim = int(lib.mcr_dim(self._h))
        self.count = int(lib.mcr_count(self._h))

    def lookup(self, key: str) -> Optional[np.ndarray]:
        n = ctypes.c_uint32(0)
        raw = key.encode()
        ptr = self._lib.mcr_lookup(self._h, raw, len(raw), ctypes.byref(n))
        if not ptr:
            return None
        # Zero-copy view into the PROT_READ mapping: read-only (an in-place
        # write would fault) and pinning this reader, so that a collected
        # reader never unmaps memory a live view points at.  An explicit
        # FeatureStore.close() still invalidates outstanding views.
        arr = np.ctypeslib.as_array(ptr, shape=(int(n.value), self.dim)).view(_MappedView)
        arr._mcr_reader = self
        arr.flags.writeable = False
        return arr

    def __contains__(self, key: str) -> bool:
        return self.lookup(key) is not None

    def keys(self):
        ln = ctypes.c_uint32(0)
        for i in range(self.count):
            ptr = self._lib.mcr_key_at(self._h, i, ctypes.byref(ln))
            if ptr:
                yield ctypes.string_at(ptr, ln.value).decode()

    def close(self):
        if self._h:
            self._lib.mcr_close(self._h)
            self._h = None


class _PyReader:
    """The .mcrpack format in Python (mmap + struct); used when there is no
    native library."""

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
    """Mapping-protocol reader over an .mcrpack file: the native reader
    when :func:`native_library` finds one, else the Python reader."""

    def __init__(self, path: str, *, prefer_native: bool = True):
        lib = native_library() if prefer_native else None
        self._reader = _NativeReader(path, lib) if lib is not None else _PyReader(path)
        self.native = isinstance(self._reader, _NativeReader)

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
