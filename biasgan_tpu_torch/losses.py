"""GAN and reconstruction losses, computed in f32 whatever the compute
dtype.

Counterpart of ``gan_loss`` and ``l1_loss`` in ``biasgan_tpu/losses.py``
(:22-41): the reference's GANLoss criteria (vanilla BCE-with-logits, lsgan
MSE, the wgangp sign form) and the L1 of the cycle and identity terms.
``gradient_penalty`` arrives with pix2pix's wgangp training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GAN_MODES = ("vanilla", "lsgan", "wgangp")


def gan_loss(prediction: torch.Tensor, target_is_real: bool, gan_mode: str) -> torch.Tensor:
    """vanilla: BCE-with-logits against a 1/0 label map; lsgan: MSE against
    1/0; wgangp: -mean(pred) for real, +mean(pred) for fake."""
    pred = prediction.float()
    if gan_mode == "vanilla":
        label = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
        return F.binary_cross_entropy_with_logits(pred, label)
    if gan_mode == "lsgan":
        return torch.mean(torch.square(pred - (1.0 if target_is_real else 0.0)))
    if gan_mode == "wgangp":
        return -pred.mean() if target_is_real else pred.mean()
    raise ValueError(f"unknown gan_mode {gan_mode!r}; expected one of {GAN_MODES}")


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a.float() - b.float()))
