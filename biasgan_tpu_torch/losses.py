"""GAN and reconstruction losses, computed in f32 whatever the compute
dtype.

Counterpart of ``gan_loss``, ``l1_loss`` and ``gradient_penalty`` in
``biasgan_tpu/losses.py`` (:22-74): the reference's GANLoss criteria
(vanilla BCE-with-logits, lsgan MSE, the wgangp sign form), the L1 of the
reconstruction, cycle and identity terms, and ``cal_gradient_penalty``.
"""

from __future__ import annotations

from typing import Callable, Optional

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


def gradient_penalty(
    d_apply: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    constant: float = 1.0,
    lp_type: str = "mixed",
) -> torch.Tensor:
    """WGAN-GP penalty, the reference's ``cal_gradient_penalty``: at x =
    real, fake, or (type 'mixed') alpha real + (1 - alpha) fake with one
    uniform alpha per sample (``alpha`` of shape (N, 1, 1, 1), else drawn
    on the CPU from ``generator``), mean((||dD(x)/dx|| - constant)^2), the
    gradient over all non-batch dims and sqrt(sum g^2 + 1e-16). The
    gradient keeps its graph (``create_graph``), so the penalty
    differentiates into D's parameters."""
    if lp_type == "real":
        x = real
    elif lp_type == "fake":
        x = fake
    elif lp_type == "mixed":
        if alpha is None:
            shape = (real.shape[0],) + (1,) * (real.ndim - 1)
            alpha = torch.rand(shape, generator=generator)
        alpha = alpha.to(real.device)
        x = alpha * real + (1.0 - alpha) * fake
    else:
        raise ValueError(f"unknown gradient-penalty type {lp_type!r}")
    x = x.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x).float().sum(), x, create_graph=True)
    g = grads.reshape(grads.shape[0], -1).float()
    norm = torch.sqrt(torch.sum(torch.square(g), dim=1) + 1e-16)
    return torch.mean(torch.square(norm - constant))
