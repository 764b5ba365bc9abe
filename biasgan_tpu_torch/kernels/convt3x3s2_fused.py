"""Fused up conv: torch ``ConvTranspose2d(3, stride 2, padding 1,
output_padding 1)`` on an NHWC input, the H axis zero padded and the W axis
periodic ('wrap') or zero padded, with an optional instance-norm +
activation prologue on the input and the per-(N, Cout) moments of the
output.

Counterpart of ``biasgan_tpu/ops/pallas_conv.py::convt3x3s2_fused`` (:1318)
followed by ``interleave_phases`` (:1813): the kernel writes the
(N, 2h, 2w, Cout) output itself. It is CUDA C++ for sm_90a
(csrc/convt3x3s2_fused.cu, which says what bounds it and how it is built
up), compiled with nvcc on first use and bound with ctypes.

``convt3x3s2_fused`` takes its plain PyTorch version
(``convt3x3s2_fused_plain``) for a tensor on the CPU and launches the kernel
for a CUDA tensor; there is no fallback from one to the other.
``convt3x3s2_fused.launches`` counts the kernel launches.

As in the Pallas kernel, the moments are those of the stored, down-cast
output. The prologue is ``conv3x3_fused``'s (f32 a and b, f32 math, one
cast to x's dtype), where the Pallas wrapper computes it in x's dtype (see
conv3x3s2_fused.py). The weight is IOHW (the torch conv-transpose layout), not flipped. The
boundaries match ``nn.layers.conv_transpose2d``: the bottom halo row is
zero, the right halo column is column 0 under 'wrap' and zero otherwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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
    stored_moments,
)
from biasgan_tpu_torch.ops.padding import pad_axis

W_MODES = ("wrap", "zero")


def _check_args(x, weight, bias, prologue, act_pre, w_mode) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if weight.ndim != 4 or weight.shape[0] != c or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"weight must be IOHW ({c}, Cout, 3, 3), got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[1],):
        raise ValueError(f"bias must be ({weight.shape[1]},), got {tuple(bias.shape)}")
    for t in prologue or ():
        if tuple(t.shape) != (n, c):
            raise ValueError(f"prologue tensors must be ({n}, {c}), got {tuple(t.shape)}")
    if act_pre not in ACT_CODE:
        raise ValueError(f"unknown act_pre {act_pre!r}")
    if w_mode not in W_MODES:
        raise ValueError(f"unknown w_mode {w_mode!r}; expected one of {W_MODES}")


def convt3x3s2_fused_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """Plain PyTorch version of ``convt3x3s2_fused``: the prologue, then
    the four output phases as products of the storage-dtype
    values accumulated in f32 (out(2m+py, 2j+px) from x(m+sy, j+sx) and
    W[ky, kx], see csrc/convt3x3s2_fused.cu), f32 bias, one cast, sums of
    the stored value. Set TF32 off to compare it with the kernel on the
    card."""
    _check_args(x, weight, bias, prologue, act_pre, w_mode)
    n, h, w, _ = x.shape
    cout = weight.shape[1]
    if prologue is not None:
        x = affine_act(x, *prologue, act_pre)
    # the bottom zero row and the right column (wrap or zero), after the
    # prologue
    xp = pad_axis(pad_axis(x, 1, 0, 1, "zero"), 2, 0, 1, w_mode).float()
    x00, x01 = xp[:, :h, :w], xp[:, :h, 1:]
    x10, x11 = xp[:, 1:, :w], xp[:, 1:, 1:]
    k = weight.to(x.dtype).float()

    def tap(v, ky, kx):
        return v @ k[:, :, ky, kx]

    ee = tap(x00, 1, 1)
    eo = tap(x01, 1, 0) + tap(x00, 1, 2)
    oe = tap(x10, 0, 1) + tap(x00, 2, 1)
    oo = tap(x11, 0, 0) + tap(x10, 0, 2) + tap(x01, 2, 0) + tap(x00, 2, 2)
    y = torch.stack([torch.stack([ee, eo], 3), torch.stack([oe, oo], 3)], 2)
    y = y.reshape(n, 2 * h, 2 * w, cout)
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    return (y, stored_moments(y)) if want_moments else y


_ARGTYPES = [PTR] * 8 + [INT] * 8


def _launch(x, weight, bias, prologue, act_pre, w_mode, want_moments):
    n, h, w, c = x.shape
    cout = weight.shape[1]
    dtype = check_kernel_input("convt3x3s2_fused", x, 4 * n * h * w * cout)
    dev = x.device
    # (9, C, Cout): tap ky * 3 + kx of the IOHW weight
    w9 = weight.to(x.dtype).permute(2, 3, 0, 1).reshape(9, c, cout).contiguous()
    b = None if bias is None else bias.float().contiguous()
    pa = pb = None
    if prologue is not None:
        pa, pb = (t.float().contiguous() for t in prologue)
    y = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=dev)
    part = moments = None
    if want_moments:
        tiles = num_tiles("convt3x3s2_fused", "convt3x3s2_fused_num_tiles", h, w, cout, dtype)
        part = torch.empty((2, n, tiles, cout), dtype=torch.float32, device=dev)
        moments = torch.empty((2, n, cout), dtype=torch.float32, device=dev)
    launch(
        "convt3x3s2_fused", "convt3x3s2_fused_launch", _ARGTYPES, dev,
        ptr(x), ptr(w9), ptr(b), ptr(pa), ptr(pb), ptr(y), ptr(part), ptr(moments),
        n, h, w, c, cout, dtype, PAD_CODE[w_mode], ACT_CODE[act_pre],
    )
    convt3x3s2_fused.launches += 1
    if not want_moments:
        return y
    return y, (moments[0], moments[1])


def convt3x3s2_fused(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """torch ``ConvTranspose2d(3, stride 2, padding 1, output_padding 1)``
    of NHWC ``x`` (N, H, W, C), f32 or bf16, with the IOHW ``weight``
    (C, Cout, 3, 3) cast to x's dtype and an optional f32 bias; ``w_mode``
    'wrap' makes W periodic, 'zero' pads it. ``prologue=(a, b)`` ((N, C)
    f32) makes the input ``act_pre(a*x + b)``, cast back to x's dtype.
    Returns
    ``y`` (N, 2H, 2W, Cout) in x's dtype, and with ``want_moments`` also
    ``(sum, sumsq)`` (N, Cout) f32 of the stored y.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts it in ``convt3x3s2_fused.launches``) or raises."""
    _check_args(x, weight, bias, prologue, act_pre, w_mode)
    args = (x, weight, bias, prologue, act_pre, w_mode, want_moments)
    if check_device("convt3x3s2_fused", x, [weight, bias, *(prologue or ())]):
        return convt3x3s2_fused_plain(*args)
    return _launch(*args)


convt3x3s2_fused.launches = 0
