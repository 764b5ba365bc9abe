"""Fused resnet-block conv: SAME 3x3 stride-1 conv with the pad built in the
kernel, an optional instance-norm + activation prologue on the input, and
the per-(N, Cout) moments of the output.

Counterpart of ``biasgan_tpu/ops/pallas_conv.py::conv3x3_fused`` (:771) and
its helpers ``instance_moments_to_affine`` (:541) / ``apply_affine`` (:553).
The kernels are CUDA C++ for sm_90a (csrc/conv3x3_fused.cu, which says what
bounds them and how they are built up), compiled with nvcc on first use and
bound with ctypes (kernels/build.py, kernels/common.py).

``conv3x3_fused`` takes its plain PyTorch version (pad + f32 ``F.conv2d`` +
sums, ``conv3x3_fused_plain``) for a tensor on the CPU, and launches a
kernel for a CUDA tensor; there is no fallback from one to the other. The
rule for a CUDA tensor: bf16 launches the TMA / wgmma kernel, f32 the
CUDA-core checker. The bf16 kernel loads x and stores y with TMA, which
needs C and Cout multiples of 8 and a 16-byte aligned x: the wrapper
zero-pads C up to a multiple of 8 (zero weights, zero prologue a and b)
and Cout likewise (zero weights and bias, the extra couts sliced off y and
the moments), and raises for a misaligned x. It picks the tile's couts
per call (``conv_tma.tile_geometry``), packs the weight into the
kernel's slabs (``conv_tma.pack_block_weight``, one copy) and passes a
and b zero-padded to whole 64-channel blocks. ``conv3x3_fused.launches`` counts every kernel
launch, ``conv3x3_fused.wgmma_launches`` those of the bf16 kernel.

``conv3x3_fused_t`` is its differentiable form, the counterpart of
``pallas_conv.py::conv3x3_fused_t`` (:1091, custom VJP ``_fused_diff``
:950): a ``torch.autograd.Function`` whose forward is the same call (the
kernel on the card) and whose backward is ``conv3x3_fused_bwd``, the
counterpart of ``_fused_diff_bwd`` (:972-1085, XLA ops in the reference).
For a CUDA tensor that is a second hand-written source
(csrc/conv3x3_fused_bwd.cu: the moments' pullback, the conv's input and
weight gradients with the pad's adjoint folded in, and the prologue's
chain, in four launches, counted in ``conv3x3_fused_bwd.launches``; in
bf16 the input gradient runs on the forward's TMA / wgmma tile loop with
the weight channel-transposed into its slabs (the layout of
``conv_tma.pack_block_weight(weight.transpose(0, 1))``, written by the
first launch), and the weight gradient is a wgmma GEMM over the pixels,
counted in ``conv3x3_fused_bwd.wgmma_launches``); for a CPU
tensor its plain version ``conv3x3_fused_bwd_plain``, the JAX backward
line by line in torch ops (cuDNN's dgrad and wgrad for the conv).
Where autograd records, ``conv3x3_fused`` goes through it.

``w_mode='halo'`` is the spatially sharded path's form (the Pallas
``w_mode='halo'``, pallas_conv.py:565, 714): x carries its two W pad
columns, the halo-exchanged neighbour columns, at 0 and W+1 of an
(N, H, W+2, C) input, and the output is (N, H, W, Cout). H is still padded
in the kernel, and the prologue applies to the pad columns too (they carry
the neighbour's raw conv output). The Pallas scratch layout of
``embed_halo_w`` (seven zero columns on each side, for Mosaic's 8-aligned
DMA) is not carried. ``conv3x3_fused_t`` takes it too (spatially sharded
training, ``_fused_diff_bwd``'s halo branch, pallas_conv.py:1025-1040): the
backward pads H only and runs a VALID conv on W, so dx covers all W+2
columns, and the cotangents of the two halo columns flow back through the
exchange's reverse ring to the neighbours.

Differences from the Pallas wrapper: the input is at its logical height
(no ``h_run`` tail: the kernel masks ragged tiles itself), there is no plan
argument (the tiling is the kernel's own), and the weight is OIHW.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from biasgan_tpu_torch.kernels import conv_tma
from biasgan_tpu_torch.kernels.common import (
    ACT_CODE,
    DTYPE_CODE,
    PAD_CODE,
    INT,
    PTR,
    act_f32,
    affine_act,
    check_device,
    check_kernel_input,
    launch,
    num_tiles,
    pad_channels,
    pad_couts,
    ptr,
    sm_count,
    stored_moments,
    wants_grad,
)
from biasgan_tpu_torch.kernels.conv_tma import KW
from biasgan_tpu_torch.ops.padding import pad_hw

# the W modes: the pad built in the kernel, or carried by the input
W_CODE = {**PAD_CODE, "halo": 3}
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
    for name, mode, size, codes in (("h_mode", h_mode, h, PAD_CODE),
                                    ("w_mode", w_mode, w, W_CODE)):
        if mode not in codes:
            raise ValueError(f"unknown {name} {mode!r}; expected one of {sorted(codes)}")
        if mode == "reflect" and size < 2:
            raise ValueError(f"{name}='reflect' needs a size of at least 2, got {size}")
    if w_mode == "halo" and w < 3:
        raise ValueError(f"w_mode='halo' needs the two pad columns and data, got W {w}")


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
        # (in the halo mode, the pad columns too)
        x = affine_act(x, *prologue, act_pre)
    if w_mode == "halo":
        xp = pad_hw(x, (1, 1), (0, 0), h_mode)
    else:
        xp = pad_hw(x, (1, 1), (1, 1), h_mode, w_mode)
    w = weight.to(x.dtype).float()
    y = F.conv2d(xp.permute(0, 3, 1, 2).float(), w).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    return (y, stored_moments(y)) if want_moments else y


_ARGTYPES = [PTR] * 8 + [INT] * 11


def _launch(x, weight, bias, prologue, act_pre, h_mode, w_mode, want_moments):
    n, h, w, _ = x.shape
    if w_mode == "halo":
        w -= 2  # the output's width
    cout = weight.shape[0]
    dtype = check_kernel_input("conv3x3_fused", x, n * h * w * cout)
    dev = x.device
    wgmma = x.dtype == torch.bfloat16
    cout_k, bn = cout, 0  # the kernel's Cout (bf16: a multiple of 8) and tile couts
    if wgmma:
        if x.data_ptr() % 16:
            raise ValueError("conv3x3_fused bf16 kernel needs a 16-byte aligned x "
                             "(TMA loads)")
        x, weight, prologue = pad_channels(x, weight, prologue)
        weight, bias = pad_couts(weight, bias)
        cout_k = weight.shape[0]
        bn = conv_tma.tile_geometry(n, h, w, cout_k, sm_count(dev))
        wk = conv_tma.pack_block_weight(weight, bn, x.dtype)
        n_parts = sm_count(dev)  # a moment slot per block of the persistent grid
    else:
        # weight as (9, C, Cout): the Pallas wrapper's w9
        wk = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(9, x.shape[3], cout).contiguous()
        n_parts = num_tiles("conv3x3_fused", "conv3x3_fused_num_tiles", h, w)
    c = x.shape[3]
    b = None if bias is None else bias.float().contiguous()
    pa = pb = None
    if prologue is not None:
        pa, pb = (t.float().contiguous() for t in prologue)
        pad = -c % KW
        if wgmma and pad:  # the bf16 kernel reads whole 64-channel blocks, zero past C
            pa, pb = F.pad(pa, (0, pad)), F.pad(pb, (0, pad))
        if wgmma and (pa.data_ptr() % 16 or pb.data_ptr() % 16):
            pa, pb = pa.clone(), pb.clone()  # it loads them in 16-byte vectors
    y = torch.empty((n, h, w, cout_k), dtype=x.dtype, device=dev)
    part = moments = None
    if want_moments:
        part = torch.empty((2, n, n_parts, cout_k), dtype=torch.float32, device=dev)
        moments = torch.empty((2, n, cout_k), dtype=torch.float32, device=dev)
    launch(
        "conv3x3_fused", "conv3x3_fused_launch", _ARGTYPES, dev,
        ptr(x), ptr(wk), ptr(b), ptr(pa), ptr(pb), ptr(y), ptr(part), ptr(moments),
        n, h, w, c, cout_k, n_parts, dtype, PAD_CODE[h_mode], W_CODE[w_mode],
        ACT_CODE[act_pre], bn,
    )
    conv3x3_fused.launches += 1
    conv3x3_fused.wgmma_launches += wgmma
    if cout_k != cout:
        y = y[..., :cout].contiguous()
        moments = None if moments is None else moments[..., :cout]
    if not want_moments:
        return y
    return y, tuple(moments.unbind(0))


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
    normalized input); ``w_mode='halo'`` takes x as (N, H, W+2, C) with its
    W pad columns at 0 and W+1 (module docstring). Returns ``y``
    (N, H, W, Cout) in x's dtype, and with ``want_moments`` also
    ``(sum, sumsq)`` (N, Cout) f32 of the stored y.

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    (bf16: the TMA / wgmma kernel, counted also in ``.wgmma_launches``;
    f32: the CUDA-core one; both in ``.launches``) or raises. Where
    autograd records, the call goes through ``conv3x3_fused_t``."""
    _check_args(x, weight, bias, prologue, act_pre, h_mode, w_mode)
    args = (x, weight, bias, prologue, act_pre, h_mode, w_mode, want_moments)
    if wants_grad(x, weight, bias, *(prologue or ())):
        return conv3x3_fused_t(*args)
    if check_device("conv3x3_fused", x, [weight, bias, *(prologue or ())]):
        return conv3x3_fused_plain(*args)
    return _launch(*args)


conv3x3_fused.launches = 0
conv3x3_fused.wgmma_launches = 0


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


def _check_bwd_args(x, weight, bias, a, b, y, dy, ds, dq, act_pre, h_mode, w_mode) -> None:
    _check_args(x, weight, bias, None if a is None else (a, b), act_pre, h_mode, w_mode)
    n, h, w, _ = x.shape
    cout = weight.shape[0]
    out = (n, h, w - 2 if w_mode == "halo" else w, cout)
    for name, t in (("y", y), ("dy", dy)):
        if tuple(t.shape) != out:
            raise ValueError(f"{name} must be {out}, got {tuple(t.shape)}")
    if (ds is None) != (dq is None):
        raise ValueError("ds and dq come together (the moments' cotangents) or not at all")
    for name, t in (("ds", ds), ("dq", dq)):
        if t is not None and tuple(t.shape) != (n, cout):
            raise ValueError(f"{name} must be ({n}, {cout}), got {tuple(t.shape)}")


def conv3x3_fused_bwd_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    a: Optional[torch.Tensor],
    b: Optional[torch.Tensor],
    y: torch.Tensor,
    dy: torch.Tensor,
    ds: Optional[torch.Tensor],
    dq: Optional[torch.Tensor],
    act_pre: str = "relu",
    h_mode: str = "reflect",
    w_mode: str = "wrap",
):
    """Plain PyTorch version of ``conv3x3_fused_bwd``: pallas_conv.py's
    ``_fused_diff_bwd`` (:972-1085) line by line, in torch ops as the JAX
    backward is in XLA ops (cuDNN's dgrad and wgrad for the conv's VJP).
    Set TF32 off to compare it with the kernel on the card."""
    cdt = x.dtype
    dYf = dy.float()
    if ds is not None:
        # pullback of the moments, f32, of the STORED output
        dYf = dYf + (ds[:, None, None, :] + 2.0 * dq[:, None, None, :] * y.float())
    # recompute the prologue'd input as the kernel does: f32 affine + act,
    # one cast to the compute dtype before the taps
    if a is not None:
        af = a[:, None, None, :].float()
        pre = x.float() * af + b[:, None, None, :].float()
        u = act_f32(pre, act_pre).to(cdt)
    else:
        u = x
    # dU and dW of pad + VALID conv in the compute dtype (the JAX backward's
    # preferred_element_type=cdt), then the pad's adjoint; the halo mode's W
    # pad columns are x's own, so W is a VALID conv
    halo = w_mode == "halo"
    up = pad_hw(u, (1, 1), (0, 0) if halo else (1, 1), h_mode, "zero" if halo else w_mode)
    w = weight.to(cdt)
    dUp, dW, _ = torch.ops.aten.convolution_backward(
        dYf.to(cdt).permute(0, 3, 1, 2), up.permute(0, 3, 1, 2), w,
        None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [True, True, False],
    )
    dU = dUp.permute(0, 2, 3, 1)
    dU = _unpad1(dU if halo else _unpad1(dU, 2, w_mode), 1, h_mode)
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
    return dx, dW.to(weight.dtype), dbias, da, db


_BWD_ARGTYPES = [PTR] * 14 + [INT] * 12


@functools.lru_cache(maxsize=None)
def _bwd_workspace(n, h, w, c, cout, dtype, h_code, w_code, prologue, blocks, bn) -> int:
    """Bytes of the backward's workspace for one shape (a ctypes query of
    the kernel library, once per shape)."""
    nbytes = num_tiles("conv3x3_fused_bwd", "conv3x3_fused_bwd_workspace", n, h, w, c, cout,
                       dtype, h_code, w_code, prologue, blocks, bn)
    if nbytes < 0:
        raise ValueError("conv3x3_fused_bwd kernel: workspace past 2**31 bytes")
    return nbytes


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if t is None or (t.dtype == torch.float32 and t.is_contiguous()):
        return t
    return t.float().contiguous()


def _launch_bwd(x, weight, bias, a, b, y, dy, ds, dq, act_pre, h_mode, w_mode):
    n, h, w, c = x.shape
    if w_mode == "halo":
        w -= 2  # the output's width
    cout = weight.shape[0]
    dtype = check_kernel_input("conv3x3_fused_bwd", x, n * h * w * cout)
    # autograd hands over strided cotangents; the kernel takes NHWC
    dy, y = dy.contiguous(), y.contiguous()
    for name, t in (("y", y), ("dy", dy)):
        if t.dtype != x.dtype:
            raise TypeError(f"conv3x3_fused_bwd kernel: {name} is {t.dtype}, x {x.dtype}")
    if weight.dtype not in DTYPE_CODE:
        raise TypeError(f"conv3x3_fused_bwd kernel takes a float32 or bfloat16 weight, "
                        f"got {weight.dtype}")
    dev = x.device
    wgmma = x.dtype == torch.bfloat16
    ab_dtypes = None if a is None else (a.dtype, b.dtype)
    a, b, ds, dq = (_f32(t) for t in (a, b, ds, dq))
    bn = blocks = 0
    if wgmma:
        # both products load by TMA: 16-byte rows and addresses
        if c % 8 or cout % 8:
            raise ValueError(f"conv3x3_fused_bwd bf16 kernel needs C and Cout multiples of 8 "
                             f"(TMA), got C {c}, Cout {cout}")
        for name, t in (("x", x), ("y", y), ("dy", dy)):
            if t.data_ptr() % 16:
                raise ValueError(f"conv3x3_fused_bwd bf16 kernel needs a 16-byte aligned "
                                 f"{name} (TMA loads)")
        blocks = sm_count(dev)
        bn = conv_tma.tile_geometry(n, h, x.shape[2], c, blocks)  # the dgrad's tile: dU's
        if a is not None and (a.data_ptr() % 16 or b.data_ptr() % 16):
            a, b = a.clone(), b.clone()  # the dgrad's tensor map checks them
    weight = weight.contiguous()  # OIHW; in bf16 prep packs it for the dgrad
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    # dbias, da and db: f32 views of one allocation
    small = torch.empty(cout * (bias is not None) + 2 * n * c * (a is not None),
                        dtype=torch.float32, device=dev)
    dbias = None if bias is None else small[:cout]
    da = db = None
    if a is not None:
        da, db = small[-2 * n * c:].view(2, n, c).unbind(0)
    work = torch.empty(_bwd_workspace(n, h, w, c, cout, dtype, PAD_CODE[h_mode],
                                      W_CODE[w_mode], int(a is not None), blocks, bn),
                       dtype=torch.uint8, device=dev)
    launch(
        "conv3x3_fused_bwd", "conv3x3_fused_bwd_launch", _BWD_ARGTYPES, dev,
        ptr(x), ptr(weight), ptr(a), ptr(b), ptr(y), ptr(dy), ptr(ds), ptr(dq), ptr(dx), ptr(dw),
        ptr(dbias), ptr(da), ptr(db), ptr(work),
        n, h, w, c, cout, dtype, DTYPE_CODE[weight.dtype], PAD_CODE[h_mode], W_CODE[w_mode],
        ACT_CODE[act_pre], bn, blocks,
    )
    conv3x3_fused_bwd.launches += 1
    conv3x3_fused_bwd.wgmma_launches += wgmma
    if dbias is not None:
        dbias = dbias.to(bias.dtype)
    if da is not None:
        da, db = da.to(ab_dtypes[0]), db.to(ab_dtypes[1])
    return dx, dw, dbias, da, db


def conv3x3_fused_bwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    a: Optional[torch.Tensor],
    b: Optional[torch.Tensor],
    y: torch.Tensor,
    dy: torch.Tensor,
    ds: Optional[torch.Tensor],
    dq: Optional[torch.Tensor],
    act_pre: str = "relu",
    h_mode: str = "reflect",
    w_mode: str = "wrap",
):
    """The backward of ``conv3x3_fused`` (``conv3x3_fused_t``'s): from the
    forward's inputs ``x``, ``weight``, ``bias`` and prologue ``a``, ``b``
    (or None), its stored output ``y``, and the cotangents ``dy`` of y and
    ``ds``, ``dq`` ((N, Cout) f32) of its moments (None without moments),
    returns ``(dx, dweight, dbias, da, db)`` (None where the input is None),
    each in its input's dtype. In the halo W mode dx covers the two halo
    columns too.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (csrc/conv3x3_fused_bwd.cu, four launches, counted once in
    ``conv3x3_fused_bwd.launches``, a bf16 call also in
    ``.wgmma_launches``: its products on the TMA / wgmma kernels) or
    raises. bf16 takes C and Cout multiples of 8 and a 16-byte aligned x,
    y and dy (the TMA loads), else raises."""
    args = (x, weight, bias, a, b, y, dy, ds, dq, act_pre, h_mode, w_mode)
    _check_bwd_args(*args)
    if check_device("conv3x3_fused_bwd", x, [weight, bias, a, b, y, dy, ds, dq]):
        return conv3x3_fused_bwd_plain(*args)
    return _launch_bwd(*args)


conv3x3_fused_bwd.launches = 0
conv3x3_fused_bwd.wgmma_launches = 0


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
        if not want_moments:
            ds = dq = None
        grads = conv3x3_fused_bwd(x, weight, bias, a, b, y, dy, ds, dq, act_pre, h_mode,
                                  w_mode)
        return (*grads, None, None, None, None)


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
    """Differentiable ``conv3x3_fused``: the same arguments and forward (a
    kernel on the card, counted in ``conv3x3_fused.launches``, its
    ``.wgmma_launches`` in bf16, and ``conv3x3_fused_t.launches``; the plain
    version on the CPU), and the
    exact backward of pad + conv + bias + moments, with the prologue chain
    to x, a and b. The ``--fused_blocks`` training route; in the ``halo``
    W mode, that of spatially sharded training, dx covers the two halo
    columns too."""
    _check_args(x, weight, bias, prologue, act_pre, h_mode, w_mode)
    a, b = prologue if prologue is not None else (None, None)
    out = _FusedT.apply(x, weight, bias, a, b, act_pre, h_mode, w_mode, want_moments)
    return (out[0], (out[1], out[2])) if want_moments else out


conv3x3_fused_t.launches = 0
