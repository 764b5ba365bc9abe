"""Fused instance norm + residual + activation on NHWC tensors.

Counterpart of ``biasgan_tpu/ops/pallas_fused.py::fused_instance_norm_act``
(:149, forward ``_pallas_forward`` :113). The kernel is CUDA C++ for sm_90a
(csrc/instance_norm_act.cu, which says what bounds it and how it is built
up), compiled with nvcc on first use and bound with ctypes.

``instance_norm_act`` takes its plain PyTorch version
(``instance_norm_act_plain``, the JAX ``_reference_impl``) for a tensor on
the CPU and launches the kernel for a CUDA tensor; there is no fallback
from one to the other. The kernel is one launch a call, on one of two
paths that ``norm_plan`` chooses from the shape: ``cluster`` where a slice
of x, (image, channel block with rows of at least 64 bytes) x H x W, fits
the shared memory of a thread-block cluster of at most 8 blocks (the
256x256 training step's norms but those of its 256x256 planes), else
``persistent`` (one cooperative grid, a block per SM: the globe's four
shapes and those planes). ``norm_plan`` also gives the cluster size or
grid, the pixels per block, the channel block and the shared memory,
which the C function takes as they are; plans are cached per shape, dtype
and card. A call allocates only y, and on the persistent path the partial
sums.
``instance_norm_act.launches`` counts the kernel launches,
``.cluster_launches`` and ``.persistent_launches`` those on each path; the
keyword ``persistent=True`` takes the persistent path at a shape the
cluster path would take (a check of both paths at one shape). Unlike the
JAX op, it runs at every shape: the VMEM size guard and the non-TPU
fallback of the Pallas op are TPU limits.

Where autograd records, the call goes through a ``torch.autograd.Function``
with the JAX op's VJP (``_fwd`` :175, ``_bwd`` :188): the activation's
derivative read from the output, the instance-norm pullback, and the
residual's gradient passed through. The forward keeps its f32 statistics
(mean and 1/std; on the card the forward kernel's, on the CPU
``instance_norm_stats_plain``'s) for the backward,
``instance_norm_act_bwd``: on the card a second kernel
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

import functools
from dataclasses import dataclass
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
    sm_count,
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


# The kernel's geometry (csrc/instance_norm_act.cu): threads per block, one
# block per SM (__launch_bounds__(NTH, 1)); a row (16 bytes: a channel group
# of 8 bf16 or 4 f32 channels) per thread in a layer of shared memory; the
# shared memory a block may use (H100: 227 KB); blocks per cluster (the
# portable most); the GPCs whose SMs a cluster's blocks share, counted
# low: one per GPC_SPAN SMs of the card, GPC_SMS SMs each (an H100's 132
# SMs sit in GPCs of 16 to 18, not all whole: at eight 16-SM GPCs, 8-block
# clusters queued for a second wave on the card); channel groups per task;
# pass-1 steps in flight where a range is streamed; the narrowest rows (in
# groups) the cluster path takes, 64 bytes (on an H100, 16-byte rows ran at
# under half the rate of whole rows).
NTH = 512
ROW_BYTES = 16
LAYER = NTH * ROW_BYTES
SMEM_BLOCK = 232448
CLUSTER_MAX, GPC_SPAN, GPC_SMS = 8, 18, 16
GB_MAX = 16
DEPTH = 8
CLUSTER_MIN_GB = 4


@dataclass(frozen=True)
class NormPlan:
    """One call's launch geometry. A task is an image and a block of ``gb``
    channel groups (the last block may have fewer), ``cblocks`` of them per
    image; ``ranges`` blocks share a task, block r taking pixels [r
    block_px, (r + 1) block_px) (the last fewer). ``path`` "cluster": the
    blocks of a task form a cluster and ``grid`` = ranges x cblocks x N;
    "persistent": a cooperative grid of ``grid`` blocks, tasks in rounds of
    grid / ranges. A block steps through its pixels ``NTH / gb`` at a time
    (a row per thread) and holds its last ``layers`` steps in shared memory
    (the cluster path all of them); ``smem``: dynamic shared memory per
    block; ``vec``: channels per group."""

    path: str
    vec: int
    gb: int
    cblocks: int
    ranges: int
    grid: int
    block_px: int
    layers: int
    smem: int

    @property
    def steps(self) -> int:
        """Steps of the widest block."""
        return _ceil_div(self.block_px, NTH // self.gb)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _scratch(vec: int, gb: int) -> int:
    """Shared memory bytes before the layers: the block reduction's NTH x
    vec floats, then the block's sums and statistics (2 gb vec each)."""
    return (NTH + 4 * gb) * vec * 4


def _pow2_at_most(v: int) -> int:
    return 1 << (v.bit_length() - 1)


def _cluster_plan(n, hw, vec, groups, sms):
    """The best cluster plan by a wave model: over rows of gb channel
    groups (powers of two from the widest down to CLUSTER_MIN_GB, or every
    group of a narrower C) and cluster sizes whose blocks hold every step of
    their pixels, the fewest waves of resident clusters (GPC_SMS // cs of
    them per GPC, a block per SM) times bytes per block (ties: the wider
    rows, then the smaller cluster); None where no slice fits a cluster."""
    widest = _pow2_at_most(min(groups, GB_MAX))
    best = None
    for gb in (w for w in (16, 8, 4, 2, 1) if min(CLUSTER_MIN_GB, widest) <= w <= widest):
        lanes, cblocks = NTH // gb, _ceil_div(groups, gb)
        cap_px = (SMEM_BLOCK - _scratch(vec, gb)) // LAYER * lanes
        for cs in range(_ceil_div(hw, cap_px), min(CLUSTER_MAX, hw) + 1):
            block_px = _ceil_div(hw, cs)
            if _ceil_div(hw, block_px) != cs:
                continue  # a rank would hold no pixel
            layers = _ceil_div(block_px, lanes)
            resident = max(1, sms // GPC_SPAN * (GPC_SMS // cs))
            cost = _ceil_div(n * cblocks, resident) * block_px * gb
            if best is None or cost < best[0]:
                best = (cost, NormPlan("cluster", vec, gb, cblocks, cs, cs * cblocks * n,
                                       block_px, layers, _scratch(vec, gb) + layers * LAYER))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def norm_plan(n: int, hw: int, c: int, es: int, sms: int, persistent: bool = False) -> NormPlan:
    """The plan of one call on an (n, hw, c) tensor of ``es``-byte elements
    on a card of ``sms`` SMs: the cluster path where a slice with rows of
    at least CLUSTER_MIN_GB channel groups fits a cluster (``_cluster_plan``)
    and ``persistent`` is not set; else the persistent path, a block per SM:
    gb the largest power of two <= min(groups, GB_MAX), the blocks split
    evenly over the tasks (at least a pixel each), each holding as many of
    its last steps as shared memory takes (all, where they fit)."""
    vec = ROW_BYTES // es
    groups = _ceil_div(c, vec)
    if not persistent:
        plan = _cluster_plan(n, hw, vec, groups, sms)
        if plan is not None:
            return plan
    gb = _pow2_at_most(min(groups, GB_MAX))
    cblocks = _ceil_div(groups, gb)
    tasks = n * cblocks
    ranges = max(1, min(sms // tasks, hw))
    block_px = _ceil_div(hw, ranges)
    ranges = _ceil_div(hw, block_px)
    layers = min(_ceil_div(block_px, NTH // gb), (SMEM_BLOCK - _scratch(vec, gb)) // LAYER)
    return NormPlan("persistent", vec, gb, cblocks, ranges, min(sms, ranges * tasks), block_px,
                    layers, _scratch(vec, gb) + layers * LAYER)


def plan_for(x: torch.Tensor, persistent: bool = False) -> NormPlan:
    """``norm_plan`` for NHWC ``x`` on its card."""
    n, h, w, c = x.shape
    return norm_plan(n, h * w, c, x.element_size(), sm_count(x.device), persistent)


_ARGTYPES = [PTR] * 5 + [INT] * 5 + [FLOAT] + [INT] * 7
_PATH_CODE = {"cluster": 0, "persistent": 1}


def _launch(x, residual, activation, eps, stats=None, persistent=False):
    """The forward kernel's output; its statistics go into ``stats`` ((2,
    N, C) f32) where given."""
    n, h, w, c = x.shape
    dtype = check_kernel_input("instance_norm_act", x, x.numel())
    if residual is not None and not residual.is_contiguous():
        raise ValueError("instance_norm_act kernel needs a contiguous residual")
    p = plan_for(x, persistent)
    part = None
    if p.path == "persistent":
        part = torch.empty((2, n, p.ranges, c), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    launch(
        "instance_norm_act", "instance_norm_act_launch", _ARGTYPES, x.device,
        ptr(x), ptr(residual), ptr(y), ptr(stats), ptr(part),
        n, h * w, c, dtype, ACT_CODE[activation], eps,
        _PATH_CODE[p.path], p.grid, p.ranges, p.gb, p.block_px, p.layers, p.smem,
    )
    instance_norm_act.launches += 1
    if p.path == "cluster":
        instance_norm_act.cluster_launches += 1
    else:
        instance_norm_act.persistent_launches += 1
    return y


def instance_norm_act(
    x: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    activation: str = "relu",
    eps: float = 1e-5,
    *,
    persistent: bool = False,
) -> torch.Tensor:
    """instance_norm(x) [+ residual] -> activation on NHWC ``x``, f32 or
    bf16: affine-free, f32 statistics over H and W, the residual (x's shape
    and dtype) added in f32, activation none / relu / lrelu(0.2), output in
    x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one launch, counted in ``instance_norm_act.launches`` and in its
    path's ``cluster_launches`` or ``persistent_launches``) or raises.
    ``persistent`` keeps the kernel off the cluster path (to check both
    paths). Where autograd records, the call is differentiable
    (``_InstanceNormAct``)."""
    _check_args(x, residual, activation)
    if wants_grad(x, residual):
        return _InstanceNormAct.apply(x, residual, activation, eps, persistent)
    if check_device("instance_norm_act", x, [residual]):
        return instance_norm_act_plain(x, residual, activation, eps)
    return _launch(x, residual, activation, eps, persistent=persistent)


instance_norm_act.launches = 0
instance_norm_act.cluster_launches = 0
instance_norm_act.persistent_launches = 0


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
    def forward(ctx, x, residual, activation, eps, persistent):
        if check_device("instance_norm_act", x, [residual]):
            out = instance_norm_act_plain(x, residual, activation, eps)
            stats = instance_norm_stats_plain(x, eps)
        else:
            stats = torch.empty((2, x.shape[0], x.shape[3]), dtype=torch.float32,
                                device=x.device)
            out = _launch(x, residual, activation, eps, stats, persistent)
        ctx.save_for_backward(x, out, stats)
        ctx.cfg = (activation, residual is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        activation, has_res = ctx.cfg
        x, out, stats = ctx.saved_tensors
        dx, d_res = instance_norm_act_bwd(x, out, g, stats, activation,
                                          has_res and ctx.needs_input_grad[1])
        return dx, d_res, None, None, None
