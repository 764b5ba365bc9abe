"""Synthetic climate-like fields.

Counterpart of ``smooth_field`` and ``bias_transform`` in
``biasgan_tpu/data/synthetic.py``: smooth, spatially correlated fields from a
power-law Fourier spectrum (k^-alpha), and a deterministic nonlinear "model
bias" mapping A -> B. chip_smoke.py builds its globe store from them; the
'synthetic' dataset arrives with the training slices.
"""

from __future__ import annotations

import numpy as np


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
