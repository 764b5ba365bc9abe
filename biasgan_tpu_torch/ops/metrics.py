"""The validation metric bundle of corrected fields: per-pixel, PDF and
spectral parity with the target.

Counterpart of ``biasgan_tpu/ops/metrics.py``: the same bins, the same
order of f32 operations, the same keys. Everything runs in f32 (bf16
fields are cast first). The JAX package scans large fields in chunks to
bound TPU memory; the counts are exact integers either way, so here one
``bincount`` per call takes them.
"""

from __future__ import annotations

from typing import Dict

import torch

from biasgan_tpu_torch.ops.spectral import log_spectral_distance


def histogram_pdf(x: torch.Tensor, lo: float = -1.0, hi: float = 1.0,
                  n_bins: int = 64) -> torch.Tensor:
    """Normalized per-channel histogram over ``n_bins`` fixed bins of [lo,
    hi]: x (..., C) -> (n_bins, C). A value's bin is clip(int32((x - lo) /
    (hi - lo) * n_bins), 0, n_bins - 1) in f32, in that order; values
    outside [lo, hi] land in the edge bins. The counts are divided by the
    number of pixels."""
    c = x.shape[-1]
    flat = x.float().reshape(-1, c)
    m = flat.shape[0]
    pos = (flat - lo) / (hi - lo) * n_bins
    # clamping to [-1, n_bins] first changes no finite value's bin, and
    # takes an infinity to its edge bin as XLA's saturating cast does
    idx = pos.clamp(-1.0, float(n_bins)).to(torch.int32).clamp(0, n_bins - 1).long()
    idx = idx + torch.arange(c, device=x.device) * n_bins
    counts = torch.bincount(idx.reshape(-1), minlength=n_bins * c).reshape(c, n_bins)
    return counts.t().float() / m


def pdf_distance(a: torch.Tensor, b: torch.Tensor, lo: float = -1.0, hi: float = 1.0,
                 n_bins: int = 64) -> torch.Tensor:
    """The total-variation distance between the per-channel PDFs, the
    largest over the channels (0 = identical)."""
    pa = histogram_pdf(a, lo, hi, n_bins)
    pb = histogram_pdf(b, lo, hi, n_bins)
    return (0.5 * (pa - pb).abs().sum(dim=0)).max()


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(a.float() - b.float())))


def bias(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean error (the 'bias' of bias correction)."""
    return torch.mean(a.float() - b.float())


def validation_metrics(fake: torch.Tensor, real: torch.Tensor, lo: float = -1.0,
                       hi: float = 1.0) -> Dict[str, torch.Tensor]:
    """The bundle, in this order: rmse, bias, pdf_tv (over [lo, hi]),
    log_spectral_distance."""
    return {
        "rmse": rmse(fake, real),
        "bias": bias(fake, real),
        "pdf_tv": pdf_distance(fake, real, lo, hi),
        "log_spectral_distance": log_spectral_distance(fake, real),
    }
