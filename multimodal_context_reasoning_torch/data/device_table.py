"""Device-resident image-feature table (port of the JAX package's
``data/device_table.py``): gather rows on the device, ship ids.

The host collate ships each batch's region features with the batch: [N, I,
F] floats per step, the largest host-to-device copy of the training loop
(about 52 MB of fp32 for a 32-example step at the production geometry).
With the table the whole image-feature set is copied to the card once, in
the compute dtype, and each batch carries an [N] int32 row id per candidate
row instead; ``train/step.py::model_inputs`` gathers ``table[rows]`` and
``mask[rows]`` on the device.

Wiring: :meth:`PMRDataset.use_device_table` switches a dataset's batches to
``img_row`` plus the resident ``feat_table`` / ``feat_mask_table`` tensors
(the same tensors in every batch; the trainer's copy to the device leaves
tensors already there as they are).  The table lives on one explicit
device.  On a mesh every rank holds its own whole copy, and
:meth:`DeviceFeatureTable.place` checks that the copies agree
(parallel/multihost.py).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from multimodal_context_reasoning_torch.core.device import resolve_device

# Batch keys whose leading axis is the image row, not the example row;
# train/step.py pops them for the on-device gather.
TABLE_KEYS = ("feat_table", "feat_mask_table")


class DeviceFeatureTable:
    """``image_features`` maps img_id -> ImageFeatures (a dict or the
    ``FeatureStore``: ``keys()`` and ``__getitem__``).  Rows follow the
    sorted keys; ``capacity`` pads the row axis to a fixed size (an exported
    program's shapes), and a larger set is refused."""

    def __init__(
        self,
        image_features,
        *,
        img_len: int,
        dtype: str = "bfloat16",
        capacity: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        keys = sorted(image_features.keys())
        if not keys:
            raise ValueError(
                "DeviceFeatureTable needs at least one image feature "
                "(empty mapping — wrong/mis-filtered feature file?)"
            )
        self.row = {k: i for i, k in enumerate(keys)}
        n = len(keys)
        if capacity is not None:
            if n > capacity:
                raise ValueError(
                    f"{n} image features exceed the table capacity "
                    f"{capacity} baked into the compiled program — "
                    "re-export the artifact against the larger set"
                )
            n = capacity
        table = None
        mask = np.zeros((n, img_len), np.float32)
        for i, k in enumerate(keys):
            img = image_features[k]
            if table is None:
                table = np.zeros((n, img_len, img.features.shape[-1]), np.float32)
            r = min(img.num_regions, img_len)
            table[i, :r] = img.features[:r]
            mask[i, :r] = 1.0
        self.device = resolve_device(device)
        self.table = torch.from_numpy(table).to(self.device, getattr(torch, dtype))  # [n, I, F]
        self.mask = torch.from_numpy(mask).to(self.device)                         # [n, I]

    @classmethod
    def for_config(cls, image_features, cfg, *, capacity: Optional[int] = None,
                   device: Union[str, torch.device] = "cuda") -> "DeviceFeatureTable":
        """Geometry and dtype from a ``ModCRConfig``: the table follows the
        compute dtype (the forward casts the features there; a bf16 table
        under fp32 compute would round them)."""
        return cls(
            image_features,
            img_len=cfg.img_len,
            dtype="bfloat16" if cfg.global_encoder.dtype == "bfloat16" else "float32",
            capacity=capacity,
            device=device,
        )

    def row_for(self, img_id: str) -> int:
        key = str(img_id)
        if key in self.row:
            return self.row[key]
        # the reference keys features as "img-<num>" (VCRChunkAlign.py:586)
        return self.row[f"img-{key.split('-')[-1]}"]

    def place(self, mesh=None) -> "DeviceFeatureTable":
        """Check that every rank of the process group holds the same table
        (a CRC32 digest of each tensor's bytes and shape; ``ValueError`` on
        every rank when they differ); returns the table.  Each rank keeps
        its own copy, so ``mesh`` (the JAX signature's) places nothing: the
        check spans the world."""
        from multimodal_context_reasoning_torch.parallel.multihost import check_replicated

        for name, t in zip(TABLE_KEYS, (self.table, self.mask)):
            check_replicated(t, name)
        return self

    @property
    def nbytes(self) -> int:
        return (self.table.numel() * self.table.element_size()
                + self.mask.numel() * self.mask.element_size())
