"""Spectral metrics of corrected fields: zonal and radial power spectra and
the log-spectral distance.

Counterpart of ``biasgan_tpu/ops/spectral.py:59-122``, on ``torch.fft``.
The JAX package forms its transforms as DFT matmuls only because its TPU
backend hung on ``jnp.fft``; the spectra are the same functions. Fields are
NHWC, taken in f32; spectra are per channel, averaged over the batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_BIN_CHUNK = 1 << 15  # spectrum positions per one-hot product (bounds its memory)


def zonal_power_spectrum(x: torch.Tensor) -> torch.Tensor:
    """The power along the (periodic) W axis, |rfft_W|^2 / W, averaged over
    the batch and the rows: x (N, H, W, C) -> (W // 2 + 1, C)."""
    f = torch.fft.rfft(x.float(), dim=2)
    power = (f.real.square() + f.imag.square()) / x.shape[2]
    return power.mean(dim=(0, 1))


@functools.lru_cache(maxsize=32)
def _radial_bins(h: int, w: int, n_bins: int):
    """Each position of an (h, w // 2 + 1) rfft2 spectrum's bin (the JAX
    package's numpy arithmetic: integer frequencies, the longer axis scaled
    to the shorter's fundamental, truncated, clipped), and each bin's
    count."""
    ky = np.fft.fftfreq(h)[:, None] * h
    kx = np.fft.rfftfreq(w)[None, :] * w
    scale = min(h, w) / max(h, w)
    if h <= w:
        k = np.sqrt(ky**2 + (kx * scale) ** 2)
    else:
        k = np.sqrt((ky * scale) ** 2 + kx**2)
    idx = np.clip(k.astype(np.int32), 0, n_bins - 1).reshape(-1)
    return idx.astype(np.int64), np.bincount(idx, minlength=n_bins).astype(np.float32)


def radial_power_spectrum(x: torch.Tensor, n_bins: int = 0) -> torch.Tensor:
    """The isotropic 2-D power spectrum, |rfft2|^2 / (H W) binned by radial
    wavenumber (bin k: |k| in [k, k + 1) in units of the shorter axis's
    fundamental): x (N, H, W, C) -> (n_bins, C), n_bins = min(H, W) // 2 by
    default. Each bin is its positions' mean over the batch. The binning is
    a one-hot product in chunks of positions, as the JAX package bins:
    every device sums in the same order."""
    n, h, w, c = x.shape
    if n_bins == 0:
        n_bins = min(h, w) // 2
    f = torch.fft.rfft2(x.float(), dim=(1, 2))
    power = ((f.real.square() + f.imag.square()) / (h * w)).sum(dim=0).reshape(-1, c)
    idx, counts = _radial_bins(h, w, n_bins)
    idx = torch.from_numpy(idx).to(x.device)
    binned = torch.zeros((n_bins, c), dtype=torch.float32, device=x.device)
    for s in range(0, idx.numel(), _BIN_CHUNK):
        one_hot = torch.nn.functional.one_hot(idx[s:s + _BIN_CHUNK], n_bins).float()
        binned += one_hot.t() @ power[s:s + _BIN_CHUNK]
    counts = torch.from_numpy(counts).to(x.device).clamp(min=1.0)
    return binned / counts[:, None] / n


def log_spectral_distance(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The RMS difference of the log10 radial power spectra (lower is
    better)."""
    d = torch.log10(radial_power_spectrum(a) + eps) - torch.log10(radial_power_spectrum(b) + eps)
    return torch.sqrt(torch.mean(torch.square(d)))
