"""Static-shape batch iterator (a copy of the JAX package's
``data/loader.py`` without its multi-host ``shard`` option).

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
  dataset owns CUDA tensors).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

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
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def _order(self) -> np.ndarray:
        """Example order for this epoch: shuffled from ``seed + epoch``."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _index_batches(self):
        order = self._order()
        stop = len(self) * self.batch_size if self.drop_last else len(order)
        for start in range(0, stop, self.batch_size):
            yield order[start:start + self.batch_size]

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        real = len(idx)
        if real < self.batch_size:
            # pad the final batch by repeating indices; mark the real rows
            pad = np.resize(idx, self.batch_size)
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
