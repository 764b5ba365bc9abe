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
op's VJP (``_fwd`` :175, ``_bwd`` :188): x-hat and 1/std recomputed in f32,
the activation's derivative read from the output, the instance-norm
pullback, and the residual's gradient passed through.

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
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = xf.square().mean(dim=(1, 2), keepdim=True) - mean.square()
    z = (xf - mean) * torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    if residual is not None:
        z = z + residual.float()
    return act_f32(z, activation).to(x.dtype)


_ARGTYPES = [PTR] * 5 + [INT] * 5 + [FLOAT]


def _launch(x, residual, activation, eps):
    n, h, w, c = x.shape
    dtype = check_kernel_input("instance_norm_act", x, x.numel())
    if residual is not None and not residual.is_contiguous():
        raise ValueError("instance_norm_act kernel needs a contiguous residual")
    dev = x.device
    tiles = num_tiles("instance_norm_act", "instance_norm_act_num_tiles", n, h * w, c)
    part = torch.empty((2, n, tiles, c), dtype=torch.float32, device=dev)
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


class _InstanceNormAct(torch.autograd.Function):
    """The kernel's forward with the VJP of pallas_fused.py::_bwd."""

    @staticmethod
    def forward(ctx, x, residual, activation, eps):
        out = _instance_norm_act(x, residual, activation, eps)
        ctx.save_for_backward(x, out)
        ctx.cfg = (activation, eps, residual is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        activation, eps, has_res = ctx.cfg
        x, out = ctx.saved_tensors
        xf = x.float()
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = xf.square().mean(dim=(1, 2), keepdim=True) - mean.square()
        inv = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
        xhat = (xf - mean) * inv
        dz = g.float() * _act_grad_from_out(out.float(), activation)
        m_dz = dz.mean(dim=(1, 2), keepdim=True)
        m_dzx = (dz * xhat).mean(dim=(1, 2), keepdim=True)
        dx = inv * (dz - m_dz - xhat * m_dzx)
        d_res = dz.to(x.dtype) if has_res else None
        return dx.to(x.dtype), d_res, None, None
