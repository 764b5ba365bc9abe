"""7x7 stride-1 VALID conv with one tiny channel side: the resnet
generator's stem (Cin <= 8) and head (Cout <= 8), on an input the caller
has already padded.

Counterpart of ``biasgan_tpu/ops/pallas_conv7.py::conv7x7_valid`` (:197),
both of its variants: ``smallcin`` (:142) for Cin <= 8 and ``smallcout``
(:169) for Cout <= 8; a shape with neither side tiny is refused, as there.
The kernel is CUDA C++ for sm_90a (csrc/conv7x7.cu, which says what bounds
it and how it is built up), compiled with nvcc on first use and bound with
ctypes.

``conv7x7`` takes its plain PyTorch version (``conv7x7_plain``) for a tensor
on the CPU and launches the kernel for a CUDA tensor; there is no fallback
from one to the other. ``conv7x7.launches`` counts the kernel launches.
Both accumulate in f32 and add the f32 bias before the one cast to the
input's dtype (the plain generator path adds it after a bf16 conv, so the
two round differently).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from biasgan_tpu_torch.kernels.common import (
    INT,
    PTR,
    check_device,
    check_kernel_input,
    launch,
    ptr,
)


def tiny_side(cin: int, cout: int) -> Optional[str]:
    """The variant for these channel counts ('smallcin' when Cin <= 8, else
    'smallcout' when Cout <= 8), or None when neither side is tiny."""
    if cin <= 8:
        return "smallcin"
    if cout <= 8:
        return "smallcout"
    return None


def _check_args(xp, weight, bias) -> None:
    if xp.ndim != 4:
        raise ValueError(f"xp must be NHWC, got shape {tuple(xp.shape)}")
    n, hp, wp, c = xp.shape
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 7, 7):
        raise ValueError(f"weight must be OIHW (Cout, {c}, 7, 7), got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
    if hp < 7 or wp < 7:
        raise ValueError(f"conv7x7 needs a padded input of at least 7x7, got {hp}x{wp}")
    if tiny_side(c, weight.shape[0]) is None:
        raise ValueError(f"conv7x7: neither side tiny (cin={c}, cout={weight.shape[0]})")


def conv7x7_plain(
    xp: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version of ``conv7x7``: the VALID conv of the
    storage-dtype values accumulated in f32, f32 bias, one cast. Set TF32
    off to compare it with the kernel on the card."""
    _check_args(xp, weight, bias)
    w = weight.to(xp.dtype).float()
    y = F.conv2d(xp.permute(0, 3, 1, 2).float(), w).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    return y.to(xp.dtype)


_ARGTYPES = [PTR] * 4 + [INT] * 7


def _launch(xp, weight, bias):
    n, hp, wp, c = xp.shape
    cout = weight.shape[0]
    dtype = check_kernel_input("conv7x7", xp, n * (hp - 6) * (wp - 6) * cout)
    dev = xp.device
    # (49, Cin, Cout): tap dy * 7 + dx of the OIHW weight
    w49 = weight.to(xp.dtype).permute(2, 3, 1, 0).reshape(49, c, cout).contiguous()
    b = None if bias is None else bias.float().contiguous()
    y = torch.empty((n, hp - 6, wp - 6, cout), dtype=xp.dtype, device=dev)
    launch(
        "conv7x7", "conv7x7_launch", _ARGTYPES, dev,
        ptr(xp), ptr(w49), ptr(b), ptr(y),
        n, hp, wp, c, cout, dtype, int(tiny_side(c, cout) == "smallcin"),
    )
    conv7x7.launches += 1
    return y


def conv7x7(
    xp: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """VALID 7x7 stride-1 conv (torch cross-correlation) of the padded NHWC
    ``xp`` (N, H+6, W+6, Cin), f32 or bf16, with the OIHW ``weight``
    (Cout, Cin, 7, 7) cast to xp's dtype and an optional f32 bias, where
    Cin <= 8 or Cout <= 8. Returns (N, H, W, Cout) in xp's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts it in ``conv7x7.launches``) or raises."""
    _check_args(xp, weight, bias)
    if check_device("conv7x7", xp, [weight, bias]):
        return conv7x7_plain(xp, weight, bias)
    return _launch(xp, weight, bias)


conv7x7.launches = 0
