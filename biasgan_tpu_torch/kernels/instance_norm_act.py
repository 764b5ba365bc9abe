"""Fused instance norm + residual + activation on NHWC tensors.

Counterpart of ``biasgan_tpu/ops/pallas_fused.py::fused_instance_norm_act``
(:149, forward ``_pallas_forward`` :113). The kernel is CUDA C++ for sm_90a
(csrc/instance_norm_act.cu, which says what bounds it and how it is built
up), compiled with nvcc on first use and bound with ctypes.

``instance_norm_act`` takes its plain PyTorch version
(``instance_norm_act_plain``, the JAX ``_reference_impl``) for a tensor on
the CPU and launches the kernel for a CUDA tensor; there is no fallback
from one to the other. ``instance_norm_act.launches`` counts the kernel
launches. Unlike the JAX op, it runs at every shape: the VMEM size guard
and the non-TPU fallback of the Pallas op are TPU limits. Where autograd
records, the call goes through a ``torch.autograd.Function`` with the JAX
op's VJP (``_fwd`` :175, ``_bwd`` :188): the activation's derivative read
from the output, the instance-norm pullback, and the residual's gradient
passed through. The forward keeps its f32 statistics (mean and 1/std; on
the card the forward kernel's, on the CPU ``instance_norm_stats_plain``'s)
for the backward, ``instance_norm_act_bwd``: on the card a second kernel
(csrc/instance_norm_act_bwd.cu, one or two launches, counted once in
``instance_norm_act_bwd.launches``), on the CPU its plain version
``instance_norm_act_bwd_plain``. The JAX ``_fwd`` recomputes the
statistics from x; the saved ones differ from those only by the order of
the f32 sums.

This is not ``nn.layers.norm_act`` with an instance norm: that one casts
the normalized value to the input's dtype before a residual add in that
dtype; this one adds the residual in f32 and casts once at the end.
"""

from __future__ import annotations

from typing import Optional

import torch

from biasgan_tpu_torch.kernels.common import (
    ACT_CODE,
    FLOAT,
    INT,
    PTR,
    act_f32,
    check_device,
    check_kernel_input,
    launch,
    num_tiles,
    ptr,
    wants_grad,
)


def _check_args(x, residual, activation) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(
            f"residual must match x {tuple(x.shape)} {x.dtype}, got "
            f"{tuple(residual.shape)} {residual.dtype}"
        )
    if activation not in ACT_CODE:
        raise ValueError(f"unknown activation {activation!r}")


def instance_norm_stats_plain(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The statistics of ``instance_norm_act`` as (2, N, C) f32: mean and
    1/std = rsqrt(max(E[x^2] - mean^2, 0) + eps) over H and W of NHWC
    ``x`` (pallas_fused.py:78-81)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2))
    var = xf.square().mean(dim=(1, 2)) - mean.square()
    return torch.stack((mean, torch.rsqrt(torch.clamp(var, min=0.0) + eps)))


def instance_norm_act_plain(
    x: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    activation: str = "relu",
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version of ``instance_norm_act`` (pallas_fused.py:
    77-86): f32 mean and E[x^2] over H and W, var = max(E[x^2] - mean^2, 0),
    (x - mean) * rsqrt(var + eps), the residual added in f32, the
    activation, one cast."""
    _check_args(x, residual, activation)
    mean, inv = instance_norm_stats_plain(x, eps)[:, :, None, None, :]
    z = (x.float() - mean) * inv
    if residual is not None:
        z = z + residual.float()
    return act_f32(z, activation).to(x.dtype)


_ARGTYPES = [PTR] * 5 + [INT] * 5 + [FLOAT]


def _launch(x, residual, activation, eps, stats=None):
    """The forward kernel's output; its statistics go into ``stats`` ((2,
    N, C) f32) where given."""
    n, h, w, c = x.shape
    dtype = check_kernel_input("instance_norm_act", x, x.numel())
    if residual is not None and not residual.is_contiguous():
        raise ValueError("instance_norm_act kernel needs a contiguous residual")
    dev = x.device
    tiles = num_tiles("instance_norm_act", "instance_norm_act_num_tiles", n, h * w, c)
    part = torch.empty((2, n, tiles, c), dtype=torch.float32, device=dev)
    if stats is None:
        stats = torch.empty((2, n, c), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    launch(
        "instance_norm_act", "instance_norm_act_launch", _ARGTYPES, dev,
        ptr(x), ptr(residual), ptr(y), ptr(part), ptr(stats),
        n, h * w, c, dtype, ACT_CODE[activation], eps,
    )
    instance_norm_act.launches += 1
    return y


def instance_norm_act(
    x: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    activation: str = "relu",
    eps: float = 1e-5,
) -> torch.Tensor:
    """instance_norm(x) [+ residual] -> activation on NHWC ``x``, f32 or
    bf16: affine-free, f32 statistics over H and W, the residual (x's shape
    and dtype) added in f32, activation none / relu / lrelu(0.2), output in
    x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts it in ``instance_norm_act.launches``) or raises. Where
    autograd records, the call is differentiable (``_InstanceNormAct``)."""
    _check_args(x, residual, activation)
    if wants_grad(x, residual):
        return _InstanceNormAct.apply(x, residual, activation, eps)
    return _instance_norm_act(x, residual, activation, eps)


def _instance_norm_act(x, residual, activation, eps):
    if check_device("instance_norm_act", x, [residual]):
        return instance_norm_act_plain(x, residual, activation, eps)
    return _launch(x, residual, activation, eps)


instance_norm_act.launches = 0


def _act_grad_from_out(out: torch.Tensor, activation: str) -> torch.Tensor:
    """relu / lrelu are monotone with act(z) > 0 <=> z > 0, so the
    derivative is read from the output (pallas_fused.py:60-69)."""
    if activation == "relu":
        return (out > 0).float()
    if activation == "lrelu":
        return torch.where(out > 0, 1.0, 0.2)
    return torch.ones_like(out)


def _check_bwd_args(x, out, g, stats, activation) -> None:
    _check_args(x, None, activation)
    for name, t in (("out", out), ("g", g)):
        if t.shape != x.shape:
            raise ValueError(f"{name} must be {tuple(x.shape)}, got {tuple(t.shape)}")
    want = (2, x.shape[0], x.shape[3])
    if tuple(stats.shape) != want:
        raise ValueError(f"stats must be {want}, got {tuple(stats.shape)}")


def instance_norm_act_bwd_plain(
    x: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    stats: torch.Tensor,
    activation: str = "relu",
    has_res: bool = False,
):
    """Plain PyTorch version of ``instance_norm_act_bwd``: pallas_fused.py's
    ``_bwd`` (:188-197) in torch ops, with x-hat and 1/std from the given
    statistics."""
    mean, inv = stats.float()[:, :, None, None, :]
    xhat = (x.float() - mean) * inv
    dz = g.float() * _act_grad_from_out(out.float(), activation)
    m_dz = dz.mean(dim=(1, 2), keepdim=True)
    m_dzx = (dz * xhat).mean(dim=(1, 2), keepdim=True)
    dx = inv * (dz - m_dz - xhat * m_dzx)
    return dx.to(x.dtype), dz.to(x.dtype) if has_res else None


_BWD_ARGTYPES = [PTR] * 7 + [INT] * 6


def _launch_bwd(x, out, g, stats, activation, has_res, two_pass):
    n, h, w, c = x.shape
    dtype = check_kernel_input("instance_norm_act_bwd", x, x.numel())
    # autograd may hand over a strided cotangent; the kernel takes NHWC
    out, g = out.contiguous(), g.contiguous()
    for name, t in (("out", out), ("g", g)):
        if t.dtype != x.dtype:
            raise TypeError(f"instance_norm_act_bwd kernel: {name} is {t.dtype}, x {x.dtype}")
    if stats.dtype != torch.float32:
        raise TypeError(f"instance_norm_act_bwd kernel: stats must be float32, got "
                        f"{stats.dtype}")
    stats = stats.contiguous()
    dev = x.device
    # 0 tiles: the one-launch cluster path, with no partial sums in memory
    tiles = num_tiles("instance_norm_act_bwd", "instance_norm_act_bwd_num_tiles",
                      n, h * w, c, dtype, int(two_pass))
    part = torch.empty((2, n, tiles, c), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    d_res = torch.empty_like(x) if has_res else None
    launch(
        "instance_norm_act_bwd", "instance_norm_act_bwd_launch", _BWD_ARGTYPES, dev,
        ptr(x), ptr(out), ptr(g), ptr(stats), ptr(dx), ptr(d_res), ptr(part),
        n, h * w, c, dtype, ACT_CODE[activation], int(two_pass),
    )
    instance_norm_act_bwd.launches += 1
    return dx, d_res


def instance_norm_act_bwd(
    x: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    stats: torch.Tensor,
    activation: str = "relu",
    has_res: bool = False,
    *,
    two_pass: bool = False,
):
    """The backward of ``instance_norm_act``: from the forward's input
    ``x``, its output ``out``, the cotangent ``g`` of out and the forward's
    statistics ``stats`` ((2, N, C) f32: mean and 1/std), returns ``(dx,
    d_res)`` in x's dtype; ``d_res``, the residual's gradient, only with
    ``has_res`` (else None).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (csrc/instance_norm_act_bwd.cu: one launch on thread-block
    clusters where a slice fits their shared memory, else two; counted
    once in ``instance_norm_act_bwd.launches``) or raises. ``two_pass``
    keeps the kernel off the cluster path (to check both paths)."""
    _check_bwd_args(x, out, g, stats, activation)
    if check_device("instance_norm_act_bwd", x, [out, g, stats]):
        return instance_norm_act_bwd_plain(x, out, g, stats, activation, has_res)
    return _launch_bwd(x, out, g, stats, activation, has_res, two_pass)


instance_norm_act_bwd.launches = 0


class _InstanceNormAct(torch.autograd.Function):
    """The kernel's forward with the VJP of pallas_fused.py::_bwd, fed by
    the forward's statistics."""

    @staticmethod
    def forward(ctx, x, residual, activation, eps):
        if check_device("instance_norm_act", x, [residual]):
            out = instance_norm_act_plain(x, residual, activation, eps)
            stats = instance_norm_stats_plain(x, eps)
        else:
            stats = torch.empty((2, x.shape[0], x.shape[3]), dtype=torch.float32,
                                device=x.device)
            out = _launch(x, residual, activation, eps, stats)
        ctx.save_for_backward(x, out, stats)
        ctx.cfg = (activation, residual is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        activation, has_res = ctx.cfg
        x, out, stats = ctx.saved_tensors
        dx, d_res = instance_norm_act_bwd(x, out, g, stats, activation,
                                          has_res and ctx.needs_input_grad[1])
        return dx, d_res, None, None
