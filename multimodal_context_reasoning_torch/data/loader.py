"""Static-shape batch iterator (a copy of the JAX package's
``data/loader.py``).

Replaces the reference's ``torch.utils.data.DataLoader`` with
``num_workers=0`` and GPU-resident ``__getitem__`` (run_PMR_ModCR.py:40-48,
Data/VCRChunkAlign.py:596-597) with a host-side iterator that

- shuffles deterministically per epoch from a seed (reference relies on
  torch's global RNG after ``set_seed``, utils/misc.py:21-27);
- always emits *full, fixed-geometry* batches (the final short batch is
  padded with repeated examples and reported via ``batch["example_mask"]``
  so eval can drop the duplicates), so every step sees one geometry;
- overlaps host featurization with device compute via a one-batch
  lookahead thread (the reference forces synchronous loading because its
  dataset owns CUDA tensors);
- with ``shard=(index, count)`` yields one data index's rows of a mesh
  (parallel/): the JAX loader's strided slice of the epoch's order, with
  the same batch count on every index.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class DataLoader:
    """Iterates fixed-shape collated batches over a PMR/VCR dataset.

    ``dataset`` must expose ``__len__`` and ``batch(indices) -> dict``.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 88,
        drop_last: bool = False,
        prefetch: bool = True,
        shard: Optional[tuple] = None,   # (data index, data-axis size)
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if shard is not None:
            idx, count = shard
            if not (0 <= idx < count):
                raise ValueError(f"bad shard {shard}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard = shard
        self.epoch = 0

    def _order(self) -> np.ndarray:
        """Example order for this epoch (shuffled from ``seed + epoch``),
        sliced to this shard: every index shuffles with the same seed and
        takes a strided slice, disjoint coverage with no coordination."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        if self.shard is not None:
            idx, count = self.shard
            order = order[idx::count]
        return order

    def __len__(self) -> int:
        """Batch count, the same on every shard: the ranks' steps run
        collectives, so they must agree on the number of batches.  Strided
        shards differ by up to one example, so with ``drop_last`` every
        shard emits the smallest shard's count of full batches, and without
        it the largest shard's count, shorter shards padding with fully
        masked batches (``example_mask`` 0 rows add nothing to the summed
        metrics)."""
        n = len(self.dataset)
        if self.shard is not None:
            count = self.shard[1]
            if self.drop_last:
                return (n // count) // self.batch_size
            n = (n + count - 1) // count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _index_batches(self):
        order = self._order()
        target = len(self)
        stop = (len(order) // self.batch_size) * self.batch_size if self.drop_last else len(order)
        emitted = 0
        for start in range(0, stop, self.batch_size):
            if emitted >= target:
                break                           # longer shard: drop extras
            yield order[start:start + self.batch_size]
            emitted += 1
        while emitted < target:                 # shorter shard: empty batches
            yield order[:0]
            emitted += 1

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        real = len(idx)
        if real < self.batch_size:
            # pad the final batch by repeating indices; mark the real rows
            # (an empty batch of a short shard repeats example 0, all masked)
            pad = (np.resize(idx, self.batch_size) if real
                   else np.zeros((self.batch_size,), np.int64))
            batch = self.dataset.batch(pad)
            mask = np.zeros((self.batch_size,), np.float32)
            mask[:real] = 1.0
        else:
            batch = self.dataset.batch(idx)
            mask = np.ones((self.batch_size,), np.float32)
        batch["example_mask"] = mask
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self.prefetch:
            for idx in self._index_batches():
                yield self._make_batch(idx)
            return

        q: "queue.Queue" = queue.Queue(maxsize=2)
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer is gone —
            an abandoned iterator (e.g. ``next(iter(loader))`` for a
            sample batch) must not leave this thread parked on a full
            queue holding batch memory forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx in self._index_batches():
                    if not _put(self._make_batch(idx)):
                        return
            except BaseException as e:  # surfaced in the consumer
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            t.join()
            if err:
                raise err[0]
        finally:
            # consumer exiting (normally or abandoned): release the producer
            stop.set()
