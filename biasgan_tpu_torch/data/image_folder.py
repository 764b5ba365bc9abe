"""Recursive image-file discovery: a copy of ``biasgan_tpu/data/image_folder.py``
(the reference's ``data/image_folder.py`` ``make_dataset`` /
IMG_EXTENSIONS), which the port keeps its own of (the JAX package's data
modules import JAX)."""

from __future__ import annotations

import os
from typing import List, Optional

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp",
    ".tif", ".tiff", ".webp", ".npy",
)


def is_image_file(fname: str) -> bool:
    return fname.lower().endswith(IMG_EXTENSIONS)


def make_dataset(directory: str, max_size: Optional[int] = None) -> List[str]:
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"{directory} is not a valid directory")
    images = []
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    if max_size and max_size > 0:
        images = images[:max_size]
    return images
