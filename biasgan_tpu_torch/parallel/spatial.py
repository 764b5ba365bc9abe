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
``rdma`` the ``halo_exchange_w`` kernel on the card.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from biasgan_tpu_torch.kernels.halo_exchange import (
    HaloRing,
    halo_exchange_w,
    halo_exchange_w_plain,
)
from biasgan_tpu_torch.ops.padding import pad_axis


class HaloCtx:
    """The spatial context of one rank of ``n_shards`` W shards (the
    process group's ranks, in order of W). Build it on every rank at the
    same point; ``close`` likewise.

    ``rdma``: exchange halos with the ``halo_exchange_w`` kernel (on a CUDA
    tensor; on the CPU its plain version) in place of the plain
    ``batch_isend_irecv`` ring. Inference only, as in JAX."""

    def __init__(self, n_shards: int = 1, periodic: bool = True, rdma: bool = False,
                 group=None):
        self.n_shards, self.periodic, self.rdma = n_shards, periodic, rdma
        self.group = group
        self.ring = HaloRing(n_shards, periodic, group)

    @property
    def rank(self) -> int:
        return self.ring.rank

    def pad_w(self, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
        """x (N, H, W_local, C) with ``left`` neighbour columns before and
        ``right`` after, from the ring; zeros past a non-periodic global
        edge. A halo wider than the shard raises."""
        if left == right == 0:
            return x
        exchange = halo_exchange_w if self.rdma else halo_exchange_w_plain
        lh, rh = exchange(x, left, right, self.ring)
        return torch.cat([lh, x, rh], dim=2)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor on t's device)."""
        if self.n_shards == 1:
            return t
        staged = t.detach().to("cpu" if self.ring.via_host else t.device, copy=True)
        dist.all_reduce(staged, group=self.group)
        return staged.to(t.device)

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

    def gather_w(self, y: torch.Tensor) -> Optional[torch.Tensor]:
        """The shards of ``y`` concatenated along W on rank 0 (None on the
        other ranks)."""
        if self.n_shards == 1:
            return y
        staged = y.detach().to("cpu" if self.ring.via_host else y.device).contiguous()
        parts = [torch.empty_like(staged) for _ in range(self.n_shards)] if self.rank == 0 else None
        dist.gather(staged, parts, dst=0, group=self.group)
        return torch.cat(parts, dim=2).to(y.device) if self.rank == 0 else None

    def barrier(self) -> None:
        self.ring.barrier()

    def close(self) -> None:
        self.ring.close()


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
