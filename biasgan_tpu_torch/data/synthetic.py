"""Synthetic paired climate-like fields: the 'synthetic' dataset.

Counterpart of ``biasgan_tpu/data/synthetic.py``: smooth, spatially
correlated fields from a power-law Fourier spectrum (k^-alpha), and a
deterministic nonlinear "model bias" mapping A -> B for the generator to
invert. Deterministic per (seed, index), with the JAX package's numpy
draws, so both packages read the same samples. chip_smoke.py builds its
globe store from the same functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from biasgan_tpu_torch.registry import register_dataset


@dataclass
class SyntheticConfig:
    synthetic_samples: int = 128
    synthetic_alpha: float = 2.0  # spectral slope of the random fields


def smooth_field(rng: np.random.Generator, h: int, w: int, alpha: float) -> np.ndarray:
    """Random field with isotropic k^-alpha spectrum, normalized to [-1, 1]."""
    ky = np.fft.fftfreq(h)[:, None]
    kx = np.fft.rfftfreq(w)[None, :]
    k = np.sqrt(ky**2 + kx**2)
    k[0, 0] = 1.0
    amp = k ** (-alpha / 2.0)
    amp[0, 0] = 0.0
    phase = rng.uniform(0, 2 * np.pi, size=amp.shape)
    spec = amp * np.exp(1j * phase)
    field = np.fft.irfft2(spec, s=(h, w))
    m = np.max(np.abs(field)) or 1.0
    return (field / m).astype(np.float32)


def bias_transform(a: np.ndarray) -> np.ndarray:
    """Deterministic nonlinear 'model bias': the mapping G must learn."""
    return np.tanh(1.2 * a + 0.5 * a * a - 0.1).astype(np.float32)


@register_dataset("synthetic", SyntheticConfig)
class SyntheticDataset:
    @staticmethod
    def config_defaults(train: bool):
        return {"in_graph_aug": True}

    def __init__(self, cfg):
        self.h = self.w = cfg.crop_size
        self.channels = cfg.input_nc
        self.n = cfg.synthetic_samples
        self.seed = cfg.seed
        self.alpha = cfg.synthetic_alpha

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, index))
        a = np.stack(
            [smooth_field(rng, self.h, self.w, self.alpha) for _ in range(self.channels)],
            axis=-1,
        )
        return {
            "A": a,
            "B": bias_transform(a),
            "A_paths": f"synthetic://{index}",
            "B_paths": f"synthetic://{index}",
        }
