"""Spatial sharding: the generator on W (longitude) shards, one process per
shard, exactly the whole-field forward.

Counterpart of ``biasgan_tpu/parallel/spatial.py`` (``HaloCtx`` :46-121,
``pad_to_multiple`` :124, ``spatial_apply`` :241-272). The W axis of the
field is split over the ranks of the process group (``parallel/mesh.py``);
every conv pads its W axis with exactly its kernel margin from the ring
neighbours (wrap-around for periodic longitude, zeros at the global edges
otherwise), every instance norm takes its statistics over the whole W axis
(``all_reduce``), and the conv-transposes dilate locally to ``W_local * s``
before their halo pad. So the sharded forward computes the same function as
the whole-field forward, not an overlap-tile approximation.

Constraints: the global W divides by n_shards * 2^downsamples (use
``pad_to_multiple``), and reflect padding on W is unsupported (use 'wrap'
or 'zero').

Under gloo (ranks sharing a card, or the CPU) collectives on CUDA tensors
go through host copies. The halo exchange itself is the plain ring, or with
``rdma`` the ``halo_exchange_w`` kernel on the card: signalled on the
device where every rank has a card of its own, synchronised on the host
where ranks share one (``kernels/halo_exchange.py``).

Training differentiates through the context, as JAX differentiates through
``ppermute``, ``psum`` and ``all_gather``: the plain ring's backward is the
reverse ring (``kernels/halo_exchange.py``), the sum over the ranks
(``mean_w``, ``sum_w``) is an ``all_reduce`` whose backward is an
``all_reduce`` of the cotangent (``psum``'s transpose), and ``all_gather_w``
gives every rank the whole W with the backward of a tiled ``all_gather``:
this rank's slice of the cotangent summed over the ranks. So each rank's
backward computes the gradient of the sum of every rank's loss with respect
to its own copy of the parameters, and their mean over the ranks is the
gradient of the mean loss (``mean_grads_``), as ``pmean`` of the JAX step's
grads. Every rank must record the same operations in the same order, or
the collectives of the backward pair up wrongly. The halo kernel has no
backward: ``pad_w`` with ``rdma`` raises where autograd records.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from biasgan_tpu_torch.kernels.common import wants_grad
from biasgan_tpu_torch.kernels.halo_exchange import (
    HaloRing,
    halo_exchange_w,
    halo_exchange_w_plain,
)
from biasgan_tpu_torch.ops.padding import pad_axis
from biasgan_tpu_torch.parallel.mesh import RankCtx


class HaloCtx(RankCtx):
    """The spatial context of one rank of ``n_shards`` W shards (the
    process group's ranks, in order of W: the world, or a row of the 2-D
    mesh). Build it on every rank of the group at the same point; ``close``
    likewise. The losses' mean, the grads' mean and
    the bitwise check are ``RankCtx``'s.

    ``rdma``: exchange halos with the ``halo_exchange_w`` kernel (on a CUDA
    tensor; on the CPU its plain version) in place of the plain
    ``batch_isend_irecv`` ring. Inference only, as in JAX."""

    def __init__(self, n_shards: int = 1, periodic: bool = True, rdma: bool = False,
                 group=None):
        super().__init__(n_shards, group)
        self.n_shards, self.periodic, self.rdma = n_shards, periodic, rdma
        self.ring = HaloRing(n_shards, periodic, group)

    def pad_w(self, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
        """x (N, H, W_local, C) with ``left`` neighbour columns before and
        ``right`` after, from the ring; zeros past a non-periodic global
        edge. A halo wider than the shard raises, and so does ``rdma``
        where autograd records (the kernel has no backward)."""
        if left == right == 0:
            return x
        if self.rdma:
            if wants_grad(x):
                raise RuntimeError(
                    "HaloCtx(rdma=True): the halo_exchange_w kernel has no backward "
                    "(inference only, as in JAX); train with the plain ring (rdma=False)"
                )
            lh, rh = halo_exchange_w(x, left, right, self.ring)
        else:
            lh, rh = halo_exchange_w_plain(x, left, right, self.ring)
        return torch.cat([lh, x, rh], dim=2)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor on t's device);
        differentiable, where autograd records (``_Sum``)."""
        if self.n_shards == 1:
            return t
        return _Sum.apply(t, self)

    def mean_w(self, *xs: torch.Tensor, dims: Sequence[int] = (1, 2)) -> List[torch.Tensor]:
        """The mean of each of ``xs`` (of one shape) over ``dims`` (kept),
        global over the shards when W (dim 2) is among them: the local
        means, summed over the ranks in one ``all_reduce`` and divided by
        their count (exact for equal shard widths)."""
        means = [x.mean(dim=tuple(dims), keepdim=True) for x in xs]
        if 2 not in dims:
            return means
        return list(self._all_reduce(torch.stack(means)) / self.n_shards)

    def sum_w(self, t: torch.Tensor) -> torch.Tensor:
        """A per-shard sum over W (the fused convs' moments) summed over
        the shards."""
        return self._all_reduce(t)

    def all_gather_w(self, y: torch.Tensor) -> torch.Tensor:
        """The shards of ``y`` concatenated along W, on every rank (JAX
        ``all_gather(..., axis=2, tiled=True)``); differentiable, where
        autograd records: its backward is this rank's slice of the
        cotangent summed over the ranks (``_GatherW``)."""
        if self.n_shards == 1:
            return y
        return _GatherW.apply(y, self)

    def gather_w(self, y: torch.Tensor) -> Optional[torch.Tensor]:
        """The shards of ``y`` concatenated along W on the group's rank 0
        (None on the other ranks); no autograd."""
        if self.n_shards == 1:
            return y
        staged = self._staged(y)
        parts = [torch.empty_like(staged) for _ in range(self.n_shards)] if self.rank == 0 else None
        dist.gather(staged, parts, dst=self.root, group=self.group)
        return torch.cat(parts, dim=2).to(y.device) if self.rank == 0 else None

    def barrier(self) -> None:
        self.ring.barrier()

    def close(self) -> None:
        self.ring.close()


class _Sum(torch.autograd.Function):
    """``psum``: the sum over the ranks; its backward sums the cotangent
    over the ranks (``psum``'s transpose)."""

    @staticmethod
    def forward(ctx, t, hctx):
        ctx.hctx = hctx
        return hctx._sum(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.hctx._sum(g), None


class _GatherW(torch.autograd.Function):
    """The tiled ``all_gather`` on W; its backward is this rank's slice of
    the cotangent summed over the ranks. Summed, not averaged: every rank
    computes the same loss of the gathered field, and the n-fold sum of
    its gradient is what the mean over the ranks of the parameters' grads
    (``mean_grads_``) divides back out."""

    @staticmethod
    def forward(ctx, y, hctx):
        ctx.hctx = hctx
        staged = hctx._staged(y)
        parts = [torch.empty_like(staged) for _ in range(hctx.n_shards)]
        dist.all_gather(parts, staged, group=hctx.group)
        return torch.cat(parts, dim=2).to(y.device)

    @staticmethod
    def backward(ctx, g):
        hctx = ctx.hctx
        wl = g.shape[2] // hctx.n_shards
        return hctx._sum(g)[:, :, hctx.rank * wl:(hctx.rank + 1) * wl].contiguous(), None


def pad_to_multiple(
    x: torch.Tensor, multiple: int, axis: int = 2, mode: str = "wrap"
) -> Tuple[torch.Tensor, int]:
    """Pad ``axis`` at its end up to the next multiple ('wrap' is periodic
    continuation, natural for longitude). Returns (padded, original size)
    for the crop."""
    size = x.shape[axis]
    return pad_axis(x, axis, 0, -(-size // multiple) * multiple - size, mode), size


def shard_w(x: torch.Tensor, ctx: HaloCtx) -> torch.Tensor:
    """This rank's W shard of the global NHWC ``x``."""
    w = x.shape[2]
    if w % ctx.n_shards:
        raise ValueError(
            f"global width {w} does not split into {ctx.n_shards} shards; "
            "pad it with pad_to_multiple"
        )
    wl = w // ctx.n_shards
    return x[:, :, ctx.rank * wl:(ctx.rank + 1) * wl].contiguous()


def spatial_apply(G: torch.nn.Module, ctx: HaloCtx) -> Callable:
    """``fn(x_global)``: this rank's W shard of the global NHWC field
    through ``G(x_local, ctx=ctx)``, the output shards gathered along W on
    rank 0 (None on the other ranks). Every rank calls it on the same
    field."""

    def fn(x: torch.Tensor) -> Optional[torch.Tensor]:
        return ctx.gather_w(G(shard_w(x, ctx), ctx=ctx))

    return fn
