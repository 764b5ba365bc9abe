"""Fused stride-2 down conv: torch ``Conv2d(3, stride 2, padding 1)`` on an
NHWC input of even H and W, the H axis zero padded and W wrap or zero
padded, with an optional instance-norm + activation prologue on the input
and the per-(N, Cout) moments of the output.

Counterpart of ``biasgan_tpu/ops/pallas_conv.py::conv3x3s2_fused`` (:1663).
The kernel is CUDA C++ for sm_90a (csrc/conv3x3s2_fused.cu, which says what
bounds it and how it is built up), compiled with nvcc on first use and
bound with ctypes.

``conv3x3s2_fused`` takes its plain PyTorch version
(``conv3x3s2_fused_plain``) for a tensor on the CPU and launches the kernel
for a CUDA tensor; there is no fallback from one to the other.
``conv3x3s2_fused.launches`` counts the kernel launches.

As in the Pallas kernel, the moments are those of the stored, down-cast
output. Differences from the Pallas wrapper: no plan argument (the tiling
is the kernel's own), the weight is OIHW, and the prologue is
``conv3x3_fused``'s (f32 a and b, f32 math, one cast to x's dtype), where
the Pallas wrapper casts a and b to x's dtype and computes in it: in bf16
that rounding moves the served generator past the repository's bf16 rule
(csrc/conv3x3s2_fused.cu).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from biasgan_tpu_torch.kernels.common import (
    ACT_CODE,
    PAD_CODE,
    INT,
    PTR,
    affine_act,
    check_device,
    check_kernel_input,
    launch,
    num_tiles,
    ptr,
    refuse_grad,
    stored_moments,
)
from biasgan_tpu_torch.ops.padding import pad_hw

W_MODES = ("wrap", "zero")


def _check_args(x, weight, bias, prologue, act_pre, w_mode) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"conv3x3s2_fused needs even H and W, got {h}x{w}")
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(f"weight must be OIHW (Cout, {c}, 3, 3), got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
    for t in prologue or ():
        if tuple(t.shape) != (n, c):
            raise ValueError(f"prologue tensors must be ({n}, {c}), got {tuple(t.shape)}")
    if act_pre not in ACT_CODE:
        raise ValueError(f"unknown act_pre {act_pre!r}")
    if w_mode not in W_MODES:
        raise ValueError(f"unknown w_mode {w_mode!r}; expected one of {W_MODES}")


def conv3x3s2_fused_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """Plain PyTorch version of ``conv3x3s2_fused``: the prologue, the
    pad, the stride-2 conv of the storage-dtype values
    accumulated in f32, f32 bias, one cast, sums of the stored value. Set
    TF32 off to compare it with the kernel on the card."""
    _check_args(x, weight, bias, prologue, act_pre, w_mode)
    if prologue is not None:
        x = affine_act(x, *prologue, act_pre)
    xp = pad_hw(x, (1, 1), (1, 1), "zero", w_mode)
    w = weight.to(x.dtype).float()
    y = F.conv2d(xp.permute(0, 3, 1, 2).float(), w, stride=2).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    return (y, stored_moments(y)) if want_moments else y


_ARGTYPES = [PTR] * 8 + [INT] * 8


def _launch(x, weight, bias, prologue, act_pre, w_mode, want_moments):
    n, h, w, c = x.shape
    cout = weight.shape[0]
    dtype = check_kernel_input("conv3x3s2_fused", x, n * h * w * cout // 4)
    dev = x.device
    w9 = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(9, c, cout).contiguous()
    b = None if bias is None else bias.float().contiguous()
    pa = pb = None
    if prologue is not None:
        pa, pb = (t.float().contiguous() for t in prologue)
    y = torch.empty((n, h // 2, w // 2, cout), dtype=x.dtype, device=dev)
    part = moments = None
    if want_moments:
        tiles = num_tiles("conv3x3s2_fused", "conv3x3s2_fused_num_tiles", h, w, cout, dtype)
        part = torch.empty((2, n, tiles, cout), dtype=torch.float32, device=dev)
        moments = torch.empty((2, n, cout), dtype=torch.float32, device=dev)
    launch(
        "conv3x3s2_fused", "conv3x3s2_fused_launch", _ARGTYPES, dev,
        ptr(x), ptr(w9), ptr(b), ptr(pa), ptr(pb), ptr(y), ptr(part), ptr(moments),
        n, h, w, c, cout, dtype, PAD_CODE[w_mode], ACT_CODE[act_pre],
    )
    conv3x3s2_fused.launches += 1
    if not want_moments:
        return y
    return y, (moments[0], moments[1])


def conv3x3s2_fused(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """torch ``Conv2d(3, stride 2, padding 1)`` of NHWC ``x`` (N, H, W, C),
    H and W even, f32 or bf16, with the OIHW ``weight`` (Cout, C, 3, 3) cast
    to x's dtype and an optional f32 bias. H is zero padded; ``w_mode`` is
    'wrap' (periodic longitude) or 'zero'. ``prologue=(a, b)`` ((N, C) f32)
    makes the input ``act_pre(a*x + b)``, cast back to x's dtype, before
    the taps (the pad stays zero). Returns ``y`` (N, H/2, W/2, Cout) in x's
    dtype, and with ``want_moments`` also ``(sum, sumsq)`` (N, Cout) f32 of
    the stored y.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts it in ``conv3x3s2_fused.launches``) or raises; it also raises
    where autograd would record, since the kernel has no backward (the JAX
    kernel has none either: its route is inference-only)."""
    _check_args(x, weight, bias, prologue, act_pre, w_mode)
    args = (x, weight, bias, prologue, act_pre, w_mode, want_moments)
    if check_device("conv3x3s2_fused", x, [weight, bias, *(prologue or ())]):
        return conv3x3s2_fused_plain(*args)
    refuse_grad("conv3x3s2_fused", "--fused_updown is inference-only, as in JAX",
                x, weight, bias, *(prologue or ()))
    return _launch(*args)


conv3x3s2_fused.launches = 0
