"""Per-sample RNG, the host-side image preprocessing, per-variable
standardization and the in-step augmentation.

Counterpart of ``sample_rng``, ``get_params``, ``transform_image``,
``standardize`` and ``in_graph_augment`` in
``biasgan_tpu/data/transforms.py``. The image half (the reference's
get_params / get_transform: resize to --load_size, crop to --crop_size with
the pair's shared draws, power-of-2 snapping, flip, [-1, 1]) is a copy, on
PIL and numpy, so both packages read the same arrays. The augmentation
runs on the training device inside the step, with an explicit
``torch.Generator`` (the JAX key's streams cannot be matched, so the parity
tests turn it off).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Deterministic per-sample generator. Derived from (--seed, epoch,
    sample index) so results are reproducible under --seed and independent of
    worker-thread scheduling, while still varying across epochs."""
    return np.random.default_rng((int(seed), int(epoch), int(index)))


def get_params(cfg, size: Tuple[int, int], rng: np.random.Generator) -> Dict:
    """Shared random transform draws for an aligned pair (reference
    get_params). Crop positions range over the post-resize size: the actual
    image size unless a resize precedes the crop."""
    w, h = size
    new_w, new_h = w, h
    if cfg.preprocess == "resize_and_crop":
        new_w = new_h = cfg.load_size
    elif cfg.preprocess == "scale_width_and_crop":
        new_w, new_h = cfg.load_size, int(cfg.load_size * h / w)
    x = int(rng.integers(0, max(0, new_w - cfg.crop_size) + 1))
    y = int(rng.integers(0, max(0, new_h - cfg.crop_size) + 1))
    flip = bool(rng.random() > 0.5)
    return {"crop_pos": (x, y), "flip": flip}


def transform_image(
    img,
    cfg,
    params: Optional[Dict] = None,
    grayscale: bool = False,
    method=None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """PIL image -> float32 HWC in [-1, 1], reference preprocess modes:
    resize_and_crop | crop | scale_width | scale_width_and_crop | none."""
    from PIL import Image

    method = method or Image.BICUBIC
    img = img.convert("L") if grayscale else img.convert("RGB")
    pre = cfg.preprocess
    if "resize" in pre:
        img = img.resize((cfg.load_size, cfg.load_size), method)
    elif "scale_width" in pre:
        w, h = img.size
        if w != cfg.load_size:
            img = img.resize((cfg.load_size, int(cfg.load_size * h / w)), method)
    if "crop" in pre:
        if params is None:
            w, h = img.size
            r = rng if rng is not None else np.random.default_rng()
            x = int(r.integers(0, max(0, w - cfg.crop_size) + 1))
            y = int(r.integers(0, max(0, h - cfg.crop_size) + 1))
        else:
            x, y = params["crop_pos"]
        img = img.crop((x, y, x + cfg.crop_size, y + cfg.crop_size))
    if pre == "none":
        img = _make_power_2(img, base=4, method=method)
    if not cfg.no_flip:
        # aligned pairs share their draws; unaligned / single images draw a
        # fresh coin each (the reference's RandomHorizontalFlip)
        if params is not None:
            flip = params["flip"]
        else:
            r = rng if rng is not None else np.random.default_rng()
            flip = bool(r.random() > 0.5)
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img, dtype=np.float32) / 127.5 - 1.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _make_power_2(img, base: int, method):
    ow, oh = img.size
    w = int(round(ow / base) * base) or base
    h = int(round(oh / base) * base) or base
    if w == ow and h == oh:
        return img
    return img.resize((w, h), method)


def standardize(x, mean, std, inverse: bool = False):
    """Per-variable (channel) standardization of an NHWC tensor (torch or
    numpy). ``mean``/``std`` are (C,)."""
    mean = mean.reshape((1,) * (x.ndim - 1) + (-1,))
    std = std.reshape((1,) * (x.ndim - 1) + (-1,))
    if inverse:
        return x * std + mean
    return (x - mean) / std


def in_step_augment(
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    flip: bool = True,
    lon_roll: bool = False,
    keys: Tuple[str, ...] = ("A", "B"),
) -> Dict[str, torch.Tensor]:
    """Random W-flip and periodic-longitude roll per sample, the same draw
    for A and B (the reference shares get_params across a pair). Draws come
    from ``generator`` on the CPU (a flip coin, then a roll shift, per
    sample)."""
    present = [k for k in keys if k in batch]
    if not present or not (flip or lon_roll):
        return batch
    n, w = batch[present[0]].shape[0], batch[present[0]].shape[2]
    out = dict(batch)
    if flip:
        do = torch.rand(n, generator=generator) < 0.5
        for k in present:
            x = out[k]
            mask = do.to(x.device)[:, None, None, None]
            out[k] = torch.where(mask, x.flip(2), x)
    if lon_roll:
        shifts = torch.randint(0, w, (n,), generator=generator).tolist()
        for k in present:
            out[k] = torch.stack([torch.roll(img, s, dims=1) for img, s in zip(out[k], shifts)])
    return out
