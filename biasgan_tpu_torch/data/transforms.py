"""Per-sample RNG and per-variable standardization.

Counterpart of ``sample_rng`` and ``standardize`` in
``biasgan_tpu/data/transforms.py``. The image preprocessing and the random
augmentation there arrive with the training slices.
"""

from __future__ import annotations

import numpy as np


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
