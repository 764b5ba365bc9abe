"""VALID 3x3 stride-1 conv on a pre-padded NHWC input, with a bias +
residual + activation epilogue, and ``conv3x3_op``, its differentiable form
(the ``--pallas_conv`` route).

Counterpart of ``biasgan_tpu/ops/pallas_conv.py::conv3x3_valid`` (:279,
body ``_kernel`` :66, ``_epilogue`` :52; the tap9 variant) and
``conv3x3_op`` (:406, VJP ``_op_bwd`` :423). The kernel is CUDA C++ for
sm_90a (csrc/conv3x3_valid.cu, which says what bounds it and how it is
built up), compiled with nvcc on first use and bound with ctypes.

``conv3x3_valid`` takes its plain PyTorch version (``conv3x3_valid_plain``)
for a tensor on the CPU and launches the kernel for a CUDA tensor; there is
no fallback from one to the other. ``conv3x3_op`` is a
``torch.autograd.Function``: its forward is ``conv3x3_valid``, and its
input gradient is ``conv3x3_valid`` again, on the cotangent padded by 2
with the flipped, channel-transposed weights (the input grad of a VALID
conv is the full conv of the cotangent). The weight gradient is a
batch-as-contraction conv, which the JAX op leaves to XLA and the port to
``aten.convolution_backward``; dbias is an f32 sum. ``conv3x3_valid
.launches`` counts the forward launches, ``.bwd_launches`` the input-grad
launches.

The Mosaic-only parts are not carried: the width rounding to 8 or 16
(:295-307), the ``h_run`` row tail (:317-323), and the ``rowcat`` /
``shift3`` / ``im2col`` variants.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from biasgan_tpu_torch.kernels.common import (
    ACT_CODE,
    INT,
    PTR,
    act_f32,
    check_device,
    check_kernel_input,
    launch,
    ptr,
    wants_grad,
)


def _check_args(xp, weight, bias, residual, activation) -> None:
    if xp.ndim != 4:
        raise ValueError(f"xp must be NHWC, got shape {tuple(xp.shape)}")
    n, hp, wp, c = xp.shape
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(f"weight must be OIHW (Cout, {c}, 3, 3), got {tuple(weight.shape)}")
    cout = weight.shape[0]
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be ({cout},), got {tuple(bias.shape)}")
    if hp < 3 or wp < 3:
        raise ValueError(f"conv3x3_valid needs a padded input of at least 3x3, got {hp}x{wp}")
    if residual is not None and (
        tuple(residual.shape) != (n, hp - 2, wp - 2, cout) or residual.dtype != xp.dtype
    ):
        raise ValueError(
            f"residual must be ({n}, {hp - 2}, {wp - 2}, {cout}) {xp.dtype}, got "
            f"{tuple(residual.shape)} {residual.dtype}"
        )
    if activation not in ACT_CODE:
        raise ValueError(f"unknown activation {activation!r}")


def conv3x3_valid_plain(
    xp: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: str = "none",
) -> torch.Tensor:
    """Plain PyTorch version of ``conv3x3_valid``: the VALID conv of the
    storage-dtype values accumulated in f32, then + f32 bias, + residual in
    f32, the activation, one cast. Set TF32 off to compare it with the
    kernel on the card."""
    _check_args(xp, weight, bias, residual, activation)
    w = weight.to(xp.dtype).float()
    y = F.conv2d(xp.permute(0, 3, 1, 2).float(), w).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return act_f32(y, activation).to(xp.dtype)


_ARGTYPES = [PTR] * 5 + [INT] * 7


def _launch(xp, weight, bias, residual, activation, bwd=False):
    n, hp, wp, c = xp.shape
    cout = weight.shape[0]
    dtype = check_kernel_input("conv3x3_valid", xp, n * (hp - 2) * (wp - 2) * cout)
    if residual is not None and not residual.is_contiguous():
        raise ValueError("conv3x3_valid kernel needs a contiguous residual")
    dev = xp.device
    # weight as (9, C, Cout) in xp's dtype: the Pallas wrapper's w9
    w9 = weight.to(xp.dtype).permute(2, 3, 1, 0).reshape(9, c, cout).contiguous()
    b = None if bias is None else bias.float().contiguous()
    y = torch.empty((n, hp - 2, wp - 2, cout), dtype=xp.dtype, device=dev)
    launch(
        "conv3x3_valid", "conv3x3_valid_launch", _ARGTYPES, dev,
        ptr(xp), ptr(w9), ptr(b), ptr(residual), ptr(y),
        n, hp, wp, c, cout, dtype, ACT_CODE[activation],
    )
    if bwd:
        conv3x3_valid.bwd_launches += 1
    else:
        conv3x3_valid.launches += 1
    return y


def _valid(xp, weight, bias, residual, activation, bwd=False):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if check_device("conv3x3_valid", xp, [weight, bias, residual]):
        return conv3x3_valid_plain(xp, weight, bias, residual, activation)
    return _launch(xp, weight, bias, residual, activation, bwd)


def conv3x3_valid(
    xp: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: str = "none",
) -> torch.Tensor:
    """VALID 3x3 stride-1 conv (torch cross-correlation) of the padded NHWC
    ``xp`` (N, H+2, W+2, C), f32 or bf16, with the OIHW ``weight``
    (Cout, C, 3, 3) cast to xp's dtype, then, in f32, an optional f32
    ``bias``, an optional ``residual`` (N, H, W, Cout) in xp's dtype and
    ``activation`` none / relu / lrelu(0.2), cast once to xp's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts it in ``conv3x3_valid.launches``) or raises. Where autograd
    records, the call goes through ``conv3x3_op`` (no residual and no
    activation, as the JAX op) and raises otherwise on the card: the kernel
    alone would return a result with no gradient."""
    _check_args(xp, weight, bias, residual, activation)
    plain = check_device("conv3x3_valid", xp, [weight, bias, residual])
    if wants_grad(xp, weight, bias, residual):
        if residual is None and activation == "none":
            return conv3x3_op(xp, weight, bias)
        if not plain:
            raise RuntimeError(
                "conv3x3_valid with a residual or an activation has no backward "
                "(the JAX conv3x3_op takes neither); call it under torch.no_grad()"
            )
    if plain:
        return conv3x3_valid_plain(xp, weight, bias, residual, activation)
    return _launch(xp, weight, bias, residual, activation)


conv3x3_valid.launches = 0
conv3x3_valid.bwd_launches = 0


class _Conv3x3Op(torch.autograd.Function):
    """pallas_conv.py:405-454: forward and input grad on the kernel."""

    @staticmethod
    def forward(ctx, xp, weight, bias):
        ctx.save_for_backward(xp, weight, bias)
        return _valid(xp, weight, bias, None, "none")

    @staticmethod
    def backward(ctx, g):
        xp, weight, bias = ctx.saved_tensors
        # autograd hands over strided cotangents; the kernel takes NHWC
        g = g.contiguous()
        dxp = dw = db = None
        if ctx.needs_input_grad[0]:
            # the full conv of g: pad by 2, the flipped, channel-transposed
            # weights, the same VALID kernel
            kt = weight.flip(2, 3).transpose(0, 1).to(g.dtype)
            gp = F.pad(g, (0, 0, 2, 2, 2, 2)).contiguous()
            dxp = _valid(gp, kt, None, None, "none", bwd=True).to(xp.dtype)
        if ctx.needs_input_grad[1]:
            # batch-as-contraction weight grad, in the conv's dtype
            w = weight.to(xp.dtype)
            dw = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2), w, None,
                [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [False, True, False],
            )[1].to(weight.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2)).to(bias.dtype)
        return dxp, dw, db


def conv3x3_op(
    xp: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Differentiable ``conv3x3_valid`` with no residual and no activation
    (the JAX ``conv3x3_op``): (N, H+2, W+2, C) -> (N, H, W, Cout). The
    forward and the input gradient both run the kernel on the card (the
    plain version on the CPU); the caller's pad has its own adjoint."""
    _check_args(xp, weight, bias, None, "none")
    return _Conv3x3Op.apply(xp, weight, bias)
