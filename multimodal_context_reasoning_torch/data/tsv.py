"""TSV storage with line-index random access (a copy of the JAX package's
``data/tsv.py``, whose concat and reorder also close the files they read).

Rebuilds the Oscar/UNITER TSV plumbing (utils/tsv_file.py:20-85 ``TSVFile``,
utils/tsv_file_ops.py:12-92 writer/concat/reorder): a ``.tsv`` of
tab-separated rows plus a ``.lineidx`` sidecar of byte offsets, giving O(1)
row seeks without loading the file.  PID-aware reopen is preserved — forked
data-loader workers must not share a file handle's seek position.
"""

from __future__ import annotations

import os
import os.path as op
from typing import Iterable, List, Optional, Sequence


class TSVFile:
    def __init__(self, tsv_file: str, generate_lineidx: bool = True):
        self.tsv_file = tsv_file
        self.lineidx = op.splitext(tsv_file)[0] + ".lineidx"
        self._fp = None
        self._lineidx: Optional[List[int]] = None
        self._pid: Optional[int] = None
        if not op.isfile(self.lineidx) and generate_lineidx:
            self._generate_lineidx()

    def _generate_lineidx(self) -> None:
        offsets = []
        with open(self.tsv_file, "rb") as f:
            off = 0
            for line in f:
                offsets.append(off)
                off += len(line)
        with open(self.lineidx, "w") as f:
            f.writelines(f"{o}\n" for o in offsets)

    def _ensure_lineidx(self) -> List[int]:
        if self._lineidx is None:
            with open(self.lineidx) as f:
                self._lineidx = [int(l) for l in f]
        return self._lineidx

    def _ensure_fp(self):
        # reopen after fork (utils/tsv_file.py:74-81)
        if self._fp is None or self._pid != os.getpid():
            self._fp = open(self.tsv_file, "r")
            self._pid = os.getpid()
        return self._fp

    def num_rows(self) -> int:
        return len(self._ensure_lineidx())

    def __len__(self) -> int:
        return self.num_rows()

    def seek(self, idx: int) -> List[str]:
        fp = self._ensure_fp()
        fp.seek(self._ensure_lineidx()[idx])
        return [s.strip() for s in fp.readline().split("\t")]

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)

    def close(self) -> None:
        if self._fp:
            self._fp.close()
            self._fp = None


def tsv_writer(values: Iterable[Sequence], tsv_file: str, sep: str = "\t") -> None:
    """Atomic write of rows + lineidx (utils/tsv_file_ops.py:12-44)."""
    os.makedirs(op.dirname(tsv_file) or ".", exist_ok=True)
    lineidx_file = op.splitext(tsv_file)[0] + ".lineidx"
    tsv_tmp, idx_tmp = tsv_file + ".tmp", lineidx_file + ".tmp"
    off = 0
    with open(tsv_tmp, "w") as fp, open(idx_tmp, "w") as fpidx:
        for value in values:
            row = sep.join(str(v) if not isinstance(v, bytes) else v.decode()
                           for v in value) + "\n"
            fp.write(row)
            fpidx.write(f"{off}\n")
            off += len(row.encode())
    os.replace(tsv_tmp, tsv_file)
    os.replace(idx_tmp, lineidx_file)


def concat_tsv_files(tsvs: Sequence[str], out_tsv: str) -> None:
    """utils/tsv_file_ops.py:47-67."""
    def rows():
        for t in tsvs:
            f = TSVFile(t)
            try:
                for i in range(len(f)):
                    yield f[i]
            finally:
                f.close()
    tsv_writer(rows(), out_tsv)


def reorder_tsv_keys(in_tsv: str, ordered_keys: Sequence[str],
                     out_tsv: str) -> None:
    """Rewrite rows in the order of ``ordered_keys`` (first column is the
    key; utils/tsv_file_ops.py:70-92)."""
    f = TSVFile(in_tsv)
    try:
        key_to_idx = {f[i][0]: i for i in range(len(f))}
        tsv_writer((f[key_to_idx[k]] for k in ordered_keys), out_tsv)
    finally:
        f.close()
