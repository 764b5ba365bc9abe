"""Fused resnet-block conv: SAME 3x3 stride-1 conv with the pad built in the
kernel, an optional instance-norm + activation prologue on the input, and
the per-(N, Cout) moments of the output.

Counterpart of ``biasgan_tpu/ops/pallas_conv.py::conv3x3_fused`` (:771) and
its helpers ``instance_moments_to_affine`` (:541) / ``apply_affine`` (:553).
The kernel is CUDA C++ for sm_90a (csrc/conv3x3_fused.cu, which says what
bounds it and how it is built up), compiled with nvcc on first use and
bound with ctypes (kernels/build.py, kernels/common.py).

``conv3x3_fused`` takes its plain PyTorch version (pad + f32 ``F.conv2d`` +
sums, ``conv3x3_fused_plain``) for a tensor on the CPU, and launches the
kernel for a CUDA tensor; there is no fallback from one to the other.
``conv3x3_fused.launches`` counts the kernel launches.

``conv3x3_fused_t`` is its differentiable form, the counterpart of
``pallas_conv.py::conv3x3_fused_t`` (:1091, custom VJP ``_fused_diff``
:950): a ``torch.autograd.Function`` whose forward is the same call (the
kernel on the card) and whose backward is ``_fused_diff_bwd`` (:972-1085)
line by line, in torch ops as the JAX backward is in XLA ops. Where
autograd records, ``conv3x3_fused`` goes through it.

Differences from the Pallas wrapper: the input is at its logical height
(no ``h_run`` tail: the kernel masks ragged tiles itself), there is no plan
argument (the tiling is the kernel's own), and the weight is OIHW. The
``halo`` W mode waits for the spatial-sharding part of the port.
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
    act_f32,
    affine_act,
    check_device,
    check_kernel_input,
    launch,
    num_tiles,
    ptr,
    stored_moments,
    wants_grad,
)
from biasgan_tpu_torch.ops.padding import pad_hw


def instance_moments_to_affine(
    msum: torch.Tensor, msq: torch.Tensor, count: int, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum^2) per (N, C) -> the instance-norm affine (a, b) with
    y_norm = y*a + b. Matches nn.layers.instance_norm: f32 stats, biased
    variance via max(E[x^2] - E[x]^2, 0)."""
    mean = msum / count
    var = torch.clamp(msq / count - mean.square(), min=0.0)
    a = torch.rsqrt(var + eps)
    return a, -mean * a


def apply_affine(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """Per-(N, C) instance-norm affine on an NHWC conv output: f32 math,
    optional ReLU, cast back to y.dtype — the elementwise pass that closes a
    fused-kernel chain."""
    yn = y.float() * a[:, None, None, :] + b[:, None, None, :]
    if relu:
        yn = torch.clamp(yn, min=0.0)
    return yn.to(y.dtype)


def _check_args(x, weight, bias, prologue, act_pre, h_mode, w_mode) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(
            f"weight must be OIHW (Cout, {c}, 3, 3), got {tuple(weight.shape)}"
        )
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
    if prologue is not None:
        for t in prologue:
            if tuple(t.shape) != (n, c):
                raise ValueError(f"prologue tensors must be ({n}, {c}), got {tuple(t.shape)}")
    if act_pre not in ACT_CODE:
        raise ValueError(f"unknown act_pre {act_pre!r}")
    for name, mode, size in (("h_mode", h_mode, h), ("w_mode", w_mode, w)):
        if mode not in PAD_CODE:
            raise ValueError(f"unknown {name} {mode!r}; expected one of {sorted(PAD_CODE)}")
        if mode == "reflect" and size < 2:
            raise ValueError(f"{name}='reflect' needs a size of at least 2, got {size}")


def conv3x3_fused_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    h_mode: str = "reflect",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """Plain PyTorch version of ``conv3x3_fused``: prologue, pad, then the
    conv of the storage-dtype values accumulated in f32 (as the kernel and
    the Pallas kernel accumulate: a bf16 cuDNN conv rounds differently and
    moves the moments by ~1e-3), f32 bias, one cast, sums of the stored
    value. Set TF32 off to compare it with the kernel on the card."""
    _check_args(x, weight, bias, prologue, act_pre, h_mode, w_mode)
    if prologue is not None:
        # cast back to the storage dtype before the taps, as the kernel does
        x = affine_act(x, *prologue, act_pre)
    xp = pad_hw(x, (1, 1), (1, 1), h_mode, w_mode)
    w = weight.to(x.dtype).float()
    y = F.conv2d(xp.permute(0, 3, 1, 2).float(), w).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    return (y, stored_moments(y)) if want_moments else y


_ARGTYPES = [PTR] * 8 + [INT] * 9


def _launch(x, weight, bias, prologue, act_pre, h_mode, w_mode, want_moments):
    n, h, w, c = x.shape
    cout = weight.shape[0]
    dtype = check_kernel_input("conv3x3_fused", x, n * h * w * cout)
    dev = x.device
    # weight as (9, C, Cout) in x's dtype: the Pallas wrapper's w9
    w9 = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(9, c, cout).contiguous()
    b = None if bias is None else bias.float().contiguous()
    pa = pb = None
    if prologue is not None:
        pa, pb = (t.float().contiguous() for t in prologue)
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
    part = moments = None
    if want_moments:
        tiles = num_tiles("conv3x3_fused", "conv3x3_fused_num_tiles", h, w, dtype)
        part = torch.empty((2, n, tiles, cout), dtype=torch.float32, device=dev)
        moments = torch.empty((2, n, cout), dtype=torch.float32, device=dev)
    launch(
        "conv3x3_fused", "conv3x3_fused_launch", _ARGTYPES, dev,
        ptr(x), ptr(w9), ptr(b), ptr(pa), ptr(pb), ptr(y), ptr(part), ptr(moments),
        n, h, w, c, cout, dtype, PAD_CODE[h_mode], PAD_CODE[w_mode], ACT_CODE[act_pre],
    )
    conv3x3_fused.launches += 1
    if not want_moments:
        return y
    return y, (moments[0], moments[1])


def conv3x3_fused(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    h_mode: str = "reflect",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """SAME 3x3 s1 conv of NHWC ``x`` (N, H, W, C), f32 or bf16, with the
    OIHW ``weight`` (Cout, C, 3, 3) cast to x's dtype, an optional f32 bias,
    and optional ``prologue=(a, b)`` ((N, C) f32): the input becomes
    ``act_pre(a*x + b)`` cast back to x's dtype before the taps.

    ``h_mode`` in reflect/zero/wrap and ``w_mode`` in wrap/reflect/zero
    build the SAME pad (after the prologue: a zero pad is a zero of the
    normalized input). Returns ``y`` (N, H, W, Cout) in x's dtype, and with
    ``want_moments`` also ``(sum, sumsq)`` (N, Cout) f32 of the stored y.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts it in ``conv3x3_fused.launches``) or raises. Where autograd
    records, the call goes through ``conv3x3_fused_t``."""
    _check_args(x, weight, bias, prologue, act_pre, h_mode, w_mode)
    args = (x, weight, bias, prologue, act_pre, h_mode, w_mode, want_moments)
    if wants_grad(x, weight, bias, *(prologue or ())):
        return conv3x3_fused_t(*args)
    if check_device("conv3x3_fused", x, [weight, bias, *(prologue or ())]):
        return conv3x3_fused_plain(*args)
    return _launch(*args)


conv3x3_fused.launches = 0


def _unpad1(d: torch.Tensor, axis: int, mode: str) -> torch.Tensor:
    """Adjoint of a pad of 1 on each side of ``axis`` (``pad_axis``): the
    interior, with each pad slot's cotangent added onto the element it
    copied (reflect: 1 and n-2; wrap: n-1 and 0; zero: dropped)."""
    n = d.shape[axis] - 2
    core = d.narrow(axis, 1, n).clone()
    if mode != "zero":
        lo, hi = (1, n - 2) if mode == "reflect" else (n - 1, 0)
        core.narrow(axis, lo, 1).add_(d.narrow(axis, 0, 1))
        core.narrow(axis, hi, 1).add_(d.narrow(axis, n + 1, 1))
    return core


class _FusedT(torch.autograd.Function):
    """conv3x3_fused with the exact VJP of pallas_conv.py:_fused_diff."""

    @staticmethod
    def forward(ctx, x, weight, bias, a, b, act_pre, h_mode, w_mode, want_moments):
        prologue = None if a is None else (a, b)
        args = (x, weight, bias, prologue, act_pre, h_mode, w_mode, want_moments)
        if check_device("conv3x3_fused_t", x, [weight, bias, a, b]):
            out = conv3x3_fused_plain(*args)
        else:
            out = _launch(*args)
            conv3x3_fused_t.launches += 1
        y = out[0] if want_moments else out
        ctx.save_for_backward(x, weight, bias, a, b, y)
        ctx.cfg = (act_pre, h_mode, w_mode, want_moments)
        return (y, *out[1]) if want_moments else y

    @staticmethod
    def backward(ctx, dy, ds=None, dq=None):
        act_pre, h_mode, w_mode, want_moments = ctx.cfg
        x, weight, bias, a, b, y = ctx.saved_tensors
        cdt = x.dtype
        dYf = dy.float()
        if want_moments:
            # pullback of the moments, f32, of the STORED output
            dYf = dYf + (ds[:, None, None, :] + 2.0 * dq[:, None, None, :] * y.float())
        # recompute the prologue'd input as the kernel does: f32 affine +
        # act, one cast to the compute dtype before the taps
        if a is not None:
            af = a[:, None, None, :].float()
            pre = x.float() * af + b[:, None, None, :].float()
            u = act_f32(pre, act_pre).to(cdt)
        else:
            u = x
        # dU and dW of pad + VALID conv in the compute dtype (the JAX
        # backward's preferred_element_type=cdt), then the pad's adjoint
        up = pad_hw(u, (1, 1), (1, 1), h_mode, w_mode)
        w = weight.to(cdt)
        dUp, dW, _ = torch.ops.aten.convolution_backward(
            dYf.to(cdt).permute(0, 3, 1, 2), up.permute(0, 3, 1, 2), w,
            None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [True, True, False],
        )
        dU = _unpad1(_unpad1(dUp.permute(0, 2, 3, 1), 2, w_mode), 1, h_mode)
        dbias = None if bias is None else dYf.sum(dim=(0, 1, 2)).to(bias.dtype)
        da = db = None
        if a is not None:
            dUf = dU.float()
            if act_pre == "relu":
                dpre = dUf * (pre > 0)
            elif act_pre == "lrelu":
                dpre = dUf * torch.where(pre > 0, 1.0, 0.2)
            else:
                dpre = dUf
            dx = (dpre * af).to(x.dtype)
            da = (dpre * x.float()).sum(dim=(1, 2)).to(a.dtype)
            db = dpre.sum(dim=(1, 2)).to(b.dtype)
        else:
            dx = dU.to(x.dtype)
        return dx, dW.to(weight.dtype), dbias, da, db, None, None, None, None


def conv3x3_fused_t(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    h_mode: str = "reflect",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """Differentiable ``conv3x3_fused``: the same arguments and forward (the
    kernel on the card, counted in ``conv3x3_fused.launches`` and
    ``conv3x3_fused_t.launches``; the plain version on the CPU), and the
    exact backward of pad + conv + bias + moments, with the prologue chain
    to x, a and b. The ``--fused_blocks`` training route."""
    _check_args(x, weight, bias, prologue, act_pre, h_mode, w_mode)
    a, b = prologue if prologue is not None else (None, None)
    out = _FusedT.apply(x, weight, bias, a, b, act_pre, h_mode, w_mode, want_moments)
    return (out[0], (out[1], out[2])) if want_moments else out


conv3x3_fused_t.launches = 0
