"""CLIP image preprocessing: resize → center-crop → normalize (a copy of the
JAX package's ``data/clip_preprocess.py``).

Reproduces the ``preprocess`` transform ``clip.load`` returns
(run_PMR_ModCR.py:450): bicubic resize of the short side to
``image_size``, center crop, scale to [0, 1], normalize with the CLIP
RGB statistics.  Output is **NHWC float32**, the input models/clip.py
takes (it permutes once before ``conv1``) — the reference's torchvision
pipeline emits NCHW; only the layout differs, not the values.

PIL handles decode + bicubic resampling (same resampler torchvision uses
on PIL inputs), so values match the reference path to within resampler
rounding.  PIL is imported inside the functions, so the package imports
without it.
"""

from __future__ import annotations

from typing import Iterable, List, Union

import numpy as np

# OpenAI CLIP normalization constants (behavioral spec).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _to_pil(image):
    from PIL import Image

    if isinstance(image, Image.Image):
        return image.convert("RGB")
    if isinstance(image, str):
        return Image.open(image).convert("RGB")
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return Image.fromarray(arr).convert("RGB")


def preprocess_image(image, image_size: int = 224) -> np.ndarray:
    """One image (path, PIL image, or HWC uint8 array) → [S, S, 3] f32."""
    from PIL import Image

    img = _to_pil(image)
    w, h = img.size
    # torchvision Resize(n) semantics (the reference's clip.load
    # preprocess): short side → n exactly, long side TRUNCATED to
    # int(n * long / short) — round() here would shift every pixel of the
    # resampled grid vs the reference on ~half of aspect ratios.
    if w <= h:
        nw, nh = image_size, int(image_size * h / w)
    else:
        nw, nh = int(image_size * w / h), image_size
    img = img.resize((nw, nh), Image.BICUBIC)
    # torchvision CenterCrop: offsets are int(round(diff / 2.0)), not //2
    left = int(round((nw - image_size) / 2.0))
    top = int(round((nh - image_size) / 2.0))
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def preprocess_images(images: Union[Iterable, np.ndarray],
                      image_size: int = 224) -> np.ndarray:
    """Batch of images → [B, S, S, 3] float32 NHWC."""
    out: List[np.ndarray] = [preprocess_image(im, image_size)
                             for im in images]
    return np.stack(out, axis=0)
