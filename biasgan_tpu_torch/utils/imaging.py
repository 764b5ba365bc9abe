"""Array <-> image helpers (the reference's util/util.py tensor2im and
save_image). Counterpart of ``biasgan_tpu/utils/imaging.py``: the same
pixels from the same values. Torch tensors are read on the host in f32
(exact for bf16); PIL is imported when an image is saved."""

from __future__ import annotations

import os

import numpy as np


def to_numpy(arr) -> np.ndarray:
    """A torch tensor (any device, any float dtype) or array as f32
    numpy."""
    if hasattr(arr, "detach"):
        arr = arr.detach().float().cpu().numpy()
    return np.asarray(arr, dtype=np.float32)


def tensor2im(arr, imtype=np.uint8) -> np.ndarray:
    """(N)HWC float in [-1, 1] -> HWC uint8, of the first batch element (as
    the reference). A field outside [-1, 1] (standardized, no tanh) is
    min-max scaled instead; one channel is repeated to three."""
    a = to_numpy(arr)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 2:
        a = a[:, :, None]
    if a.min() < -1.001 or a.max() > 1.001:
        lo, hi = float(a.min()), float(a.max())
        a = (a - lo) / (hi - lo + 1e-12) * 2.0 - 1.0
    img = (a + 1.0) / 2.0 * 255.0
    img = np.clip(img, 0, 255)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(imtype)


def save_image(image_numpy: np.ndarray, image_path: str, aspect_ratio: float = 1.0) -> None:
    """Write an HWC uint8 image; ``aspect_ratio`` > 1 stretches H by it, < 1
    stretches W by its inverse (bicubic), as the reference's test pages."""
    from PIL import Image

    img = Image.fromarray(image_numpy)
    h, w = image_numpy.shape[0], image_numpy.shape[1]
    if aspect_ratio > 1.0:
        img = img.resize((w, int(h * aspect_ratio)), Image.BICUBIC)
    elif aspect_ratio < 1.0:
        img = img.resize((int(w / aspect_ratio), h), Image.BICUBIC)
    os.makedirs(os.path.dirname(image_path) or ".", exist_ok=True)
    img.save(image_path)


def save_field(field, path: str) -> None:
    """Save a gridded field (tensor, in f32, or array) as .npy, lossless,
    for downstream analysis."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, to_numpy(field) if hasattr(field, "detach") else np.asarray(field))


def diagnose_network(net, name: str = "network") -> float:
    """The mean |value| of a network's parameters; one implementation, in
    ``utils/diagnostics.py``."""
    from biasgan_tpu_torch.utils.diagnostics import diagnose_network as _dn

    return _dn(net, name)


def mkdirs(paths) -> None:
    for p in paths if isinstance(paths, (list, tuple)) else [paths]:
        os.makedirs(p, exist_ok=True)
