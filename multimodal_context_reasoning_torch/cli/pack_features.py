"""Convert a reference feature pickle into the ``.mcrpack`` store (port of
the JAX package's ``cli/pack_features.py``).

One-time offline step; afterwards pass the .mcrpack path to
``--img_feat_file`` and the data loader reads region features zero-copy
through the C++ mmap library (native/feature_store.cpp, data/feature_store.py)
instead of holding the whole unpickled dict in RAM
(Data/VCRChunkAlign.py:778-781).

    python -m multimodal_context_reasoning_torch.cli.pack_features \\
        --pickle pmr_feats.pkl --out pmr_feats.mcrpack
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from multimodal_context_reasoning_torch.data.feature_store import write_pack


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pickle", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    with open(args.pickle, "rb") as f:
        raw = pickle.load(f)
    feats = {}
    for key, val in raw.items():
        arr = val["features"] if isinstance(val, dict) else val
        if hasattr(arr, "cpu"):  # torch tensor pickles
            arr = arr.cpu().numpy()
        feats[str(key)] = np.asarray(arr, np.float32)
    write_pack(feats, args.out)
    dim = next(iter(feats.values())).shape[1]
    print(f"packed {len(feats)} images (dim {dim}) -> {args.out}")


if __name__ == "__main__":
    main()
