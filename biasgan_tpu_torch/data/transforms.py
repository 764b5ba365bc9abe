"""Per-sample RNG, per-variable standardization and the in-step
augmentation.

Counterpart of ``sample_rng``, ``standardize`` and ``in_graph_augment`` in
``biasgan_tpu/data/transforms.py``. The augmentation runs on the training
device inside the step, with an explicit ``torch.Generator`` (the JAX key's
streams cannot be matched, so the parity tests turn it off). The image
preprocessing there arrives with the image datasets.
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
