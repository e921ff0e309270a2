"""Multi-task dataset mixing: one batch stream over PMR and VCR featurizers
(port of the JAX package's ``data/mixed.py``).

Both featurizers emit the same fixed-geometry candidate batches
(data/collate.py::BatchSpec), so a mixture is index concatenation: each
example is featurized by its owning dataset (the PMR prompt template and the
VCR truncation stay task-faithful) and one collate runs over the union.
``cli/train_two_stage.py --stage1_task both`` pretrains the ChunkAlign
towers on such a mixture.

In device-table mode (:meth:`MixedDataset.use_device_table`, data/
device_table.py) every child gathers from one resident table over the union
of their image ids, and the batch carries ``img_row`` and the table's
tensors; children on different tables are refused.
"""

from __future__ import annotations

from typing import Dict, Sequence


from multimodal_context_reasoning_torch.data.collate import collate_candidates, table_rows


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
        # device-table mode: every child gathers from the same table, or the
        # batch's table tensors would differ per example
        tables = {id(getattr(d, "device_table", None)) for d in self.datasets}
        if len(tables) != 1:
            raise ValueError(
                "children disagree on device-table mode; build ONE table "
                "over the union of img_ids and use_device_table() it on "
                "every child (or none)")
        self.device_table = getattr(self.datasets[0], "device_table", None)

    def __len__(self) -> int:
        return len(self._owner)

    def use_device_table(self, table) -> None:
        """Switch the mixture and every child to device-table mode."""
        self.device_table = table
        for d in self.datasets:
            d.use_device_table(table)

    def batch(self, indices: Sequence[int]) -> Dict:
        owners = [self._owner[int(i)] for i in indices]
        cands = [d._featurize_cached(j) for d, j in owners]
        table = self.device_table
        if table is None:
            imgs = [d.get_image(d.examples[j]) for d, j in owners]
            return collate_candidates(cands, imgs, self.spec)
        out = collate_candidates(cands, None, self.spec)
        out["img_row"] = table_rows(table, [d.examples[j].img_id for d, j in owners],
                                    self.spec.num_labels)
        out["feat_table"] = table.table
        out["feat_mask_table"] = table.mask
        return out
