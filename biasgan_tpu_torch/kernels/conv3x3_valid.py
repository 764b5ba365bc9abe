"""VALID 3x3 stride-1 conv on a pre-padded NHWC input, with a bias +
residual + activation epilogue, and ``conv3x3_op``, its differentiable form
(the ``--pallas_conv`` route).

Counterpart of ``biasgan_tpu/ops/pallas_conv.py::conv3x3_valid`` (:279,
body ``_kernel`` :66, ``_epilogue`` :52; the tap9 variant) and
``conv3x3_op`` (:406, VJP ``_op_bwd`` :423). The kernels are CUDA C++ for
sm_90a (csrc/conv3x3_valid.cu, which says what bounds them and how they
are built up), compiled with nvcc on first use and bound with ctypes.

``conv3x3_valid`` takes its plain PyTorch version (``conv3x3_valid_plain``)
for a tensor on the CPU and launches a kernel for a CUDA tensor; there is
no fallback from one to the other. The rule for a CUDA tensor: bf16
launches the TMA / wgmma kernel (K1's tile loop, csrc/conv3x3_tma.cuh), f32
the CUDA-core checker. The bf16 kernel loads x and the residual and stores
y with TMA, which needs C and Cout multiples of 8 and 16-byte aligned
tensors: ``bf16_operands`` zero-pads x's channels, the bias and the
residual to multiples of 8 (the extra couts are sliced off y), picks the
tile's couts (``conv_tma.tile_geometry``) and packs the weight into the
kernel's slabs (``conv_tma.pack_block_weight``, one copy, the cast
included); a misaligned x or residual raises.

``conv3x3_op`` is a ``torch.autograd.Function``: its forward is
``conv3x3_valid``, and its input gradient ``conv3x3_valid_dx``, the same
kernel on the unpadded cotangent with a zero pad of 2 on each side and the
flipped, channel-transposed weights (the input grad of a VALID conv is the
full conv of the cotangent): the kernel's box origin two rows and columns
up-left and TMA's zero fill make the pad, and the kernel reads the taps in
reverse from the transposed pack, so the backward makes no padded copy of
the cotangent and one copy of the weight. The weight gradient is a
batch-as-contraction conv, which the JAX op leaves to XLA and the port to
``aten.convolution_backward``; dbias is an f32 sum. ``conv3x3_valid
.launches`` counts the forward launches, ``.bwd_launches`` the input-grad
launches, ``.wgmma_launches`` those of both on the bf16 kernel.

The Mosaic-only parts are not carried: the width rounding to 8 or 16
(:295-307), the ``h_run`` row tail (:317-323), and the ``rowcat`` /
``shift3`` / ``im2col`` variants.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from biasgan_tpu_torch.kernels import conv_tma
from biasgan_tpu_torch.kernels.common import (
    ACT_CODE,
    INT,
    PTR,
    act_f32,
    check_device,
    check_kernel_input,
    launch,
    ptr,
    sm_count,
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


def conv3x3_valid_dx_plain(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``conv3x3_valid_dx``: ``conv3x3_valid_plain``
    of the cotangent padded by 2 with the flipped, channel-transposed
    weight in g's dtype (the JAX ``_op_bwd``, pallas_conv.py:423-440)."""
    kt = weight.flip(2, 3).transpose(0, 1).to(g.dtype)
    return conv3x3_valid_plain(F.pad(g, (0, 0, 2, 2, 2, 2)), kt)


def bf16_operands(x, weight, bias, residual, bwd, sms):
    """What the bf16 kernel takes for one call on a card of ``sms`` SMs:
    ``(x, packed weight, bias, residual, cout_k, bn)``. x's channels, the
    f32 bias and the residual zero-padded to multiples of 8 (cout_k is
    Cout rounded up to 8), the tile's couts ``bn`` from
    ``conv_tma.tile_geometry`` at the output's shape, and the weight packed
    for them in x's dtype, zero past C and Cout
    (``conv_tma.pack_block_weight``). ``bwd``: x is the unpadded cotangent
    of an input gradient (output 2 larger on each side) and ``weight`` the
    forward's OIHW weight, packed channel-transposed (a view)."""
    n, h, w, c = x.shape
    cout = weight.shape[1] if bwd else weight.shape[0]
    if bwd:
        h, w = h + 2, w + 2
    else:
        h, w = h - 2, w - 2
    if c % 8:
        x = F.pad(x, (0, -c % 8))
    cout_k = cout + -cout % 8
    bn = conv_tma.tile_geometry(n, h, w, cout_k, sms)
    packed = conv_tma.pack_block_weight(weight.transpose(0, 1) if bwd else weight, bn, x.dtype)
    if bias is not None:
        bias = F.pad(bias.float(), (0, cout_k - cout))
    if residual is not None and cout_k != cout:
        residual = F.pad(residual, (0, cout_k - cout))
    return x, packed, bias, residual, cout_k, bn


_ARGTYPES = [PTR] * 5 + [INT] * 11


def _launch(x, weight, bias, residual, activation, bwd=False):
    """One kernel launch. ``bwd``: the input gradient ``conv3x3_valid_dx``
    (x the unpadded cotangent, a zero pad of 2, the taps reversed)."""
    n, hin, win, c = x.shape
    pad = 2 if bwd else 0
    h, w = hin + 2 * pad - 2, win + 2 * pad - 2
    cout = weight.shape[1] if bwd else weight.shape[0]
    dtype = check_kernel_input("conv3x3_valid", x, n * h * w * cout)
    if residual is not None and not residual.is_contiguous():
        raise ValueError("conv3x3_valid kernel needs a contiguous residual")
    dev = x.device
    wgmma = x.dtype == torch.bfloat16
    if wgmma:
        blocks = sm_count(dev)
        x, wk, b, residual, cout_k, bn = bf16_operands(x, weight, bias, residual, bwd, blocks)
        if x.data_ptr() % 16 or (residual is not None and residual.data_ptr() % 16):
            raise ValueError("conv3x3_valid bf16 kernel needs a 16-byte aligned x and "
                             "residual (TMA loads)")
    else:
        # weight as (9, C, Cout): the Pallas wrapper's w9 (of the transposed
        # weight for the input gradient, whose taps the kernel reverses)
        perm = (2, 3, 0, 1) if bwd else (2, 3, 1, 0)
        wk = weight.to(x.dtype).permute(*perm).reshape(9, c, cout).contiguous()
        b = None if bias is None else bias.float().contiguous()
        cout_k, bn, blocks = cout, 0, 0
    y = torch.empty((n, h, w, cout_k), dtype=x.dtype, device=dev)
    launch(
        "conv3x3_valid", "conv3x3_valid_launch", _ARGTYPES, dev,
        ptr(x), ptr(wk), ptr(b), ptr(residual), ptr(y),
        n, hin, win, x.shape[3], cout_k, pad, int(bwd), dtype, ACT_CODE[activation], bn, blocks,
    )
    if bwd:
        conv3x3_valid.bwd_launches += 1
    else:
        conv3x3_valid.launches += 1
    conv3x3_valid.wgmma_launches += wgmma
    return y[..., :cout].contiguous() if cout_k != cout else y


def _valid(x, weight, bias, residual, activation, bwd=False):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if check_device("conv3x3_valid", x, [weight, bias, residual]):
        if bwd:
            return conv3x3_valid_dx_plain(x, weight)
        return conv3x3_valid_plain(x, weight, bias, residual, activation)
    return _launch(x, weight, bias, residual, activation, bwd)


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

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    (bf16: the TMA / wgmma kernel, counted also in ``.wgmma_launches``;
    f32: the CUDA-core one; both in ``conv3x3_valid.launches``) or raises.
    Where autograd records, the call goes through ``conv3x3_op`` (no
    residual and no activation, as the JAX op) and raises otherwise on the
    card: the kernel alone would return a result with no gradient."""
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
conv3x3_valid.wgmma_launches = 0


def conv3x3_valid_dx(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The input gradient of ``conv3x3_op`` with the OIHW ``weight``
    (Cout, C, 3, 3) from its cotangent ``g`` (N, H, W, Cout): the full conv
    (N, H+2, W+2, C) of g with the flipped, channel-transposed weight in
    g's dtype. A CPU tensor takes ``conv3x3_valid_dx_plain``; a CUDA tensor
    launches the kernel on g as it is (the pad of 2 made by the kernel,
    counted in ``conv3x3_valid.bwd_launches``) or raises."""
    if g.ndim != 4 or weight.ndim != 4 or tuple(weight.shape[2:]) != (3, 3) or (
            g.shape[3] != weight.shape[0]):
        raise ValueError(f"conv3x3_valid_dx: g {tuple(g.shape)} and OIHW weight "
                         f"{tuple(weight.shape)} do not match")
    return _valid(g, weight, None, None, "none", bwd=True)


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
            # the full conv of g: the same kernel with a zero pad of 2 and
            # the flipped, channel-transposed weights
            dxp = conv3x3_valid_dx(g, weight).to(xp.dtype)
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
