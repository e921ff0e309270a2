"""Multi-task dataset mixing: one batch stream over PMR and VCR featurizers
(port of the JAX package's ``data/mixed.py``).

Both featurizers emit the same fixed-geometry candidate batches
(data/collate.py::BatchSpec), so a mixture is index concatenation: each
example is featurized by its owning dataset (the PMR prompt template and the
VCR truncation stay task-faithful) and one collate runs over the union.
``cli/train_two_stage.py --stage1_task both`` pretrains the ChunkAlign
towers on such a mixture.

The JAX mixture also has a device-table mode (``use_device_table``: every
child gathers from one GPU-resident feature table, ``img_row`` /
``feat_table`` in the batch).  The port has no device table yet (ROADMAP
Queue 1, item 9), so features always come through the host collate here.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from multimodal_context_reasoning_torch.data.collate import collate_candidates


class MixedDataset:
    """Concatenates featurizer datasets that share a :class:`BatchSpec`.

    It has the surface :class:`DataLoader` reads (``__len__`` and
    ``batch(indices)``).  A batch may span children: each example's
    candidates come from its owner's ``_featurize_cached`` and the
    fixed-shape collate runs once over the union."""

    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("MixedDataset needs at least one dataset")
        self.datasets = list(datasets)
        spec0 = self.datasets[0].spec
        for d in self.datasets[1:]:
            if d.spec != spec0:
                raise ValueError(
                    f"all children must share one BatchSpec; got {d.spec} vs {spec0}")
        self.spec = spec0
        # flat index -> (child, local index); children keep their own caches
        self._owner = [(d, j) for d in self.datasets for j in range(len(d))]

    def __len__(self) -> int:
        return len(self._owner)

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        owners = [self._owner[int(i)] for i in indices]
        cands = [d._featurize_cached(j) for d, j in owners]
        imgs = [d.get_image(d.examples[j]) for d, j in owners]
        return collate_candidates(cands, imgs, self.spec)
