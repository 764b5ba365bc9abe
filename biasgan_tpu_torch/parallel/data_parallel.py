"""Data-parallel training: one process per data rank, each stepping on its
slice of every global batch.

Counterpart of ``biasgan_tpu/parallel/data_parallel.py``. The JAX step runs
under ``shard_map`` with the batch sharded on its leading axis
(``P("data")``) and the state replicated, and ``pmean``s over the data axis
explicitly: the grads of each net before its Adam, the batch-norm running
averages after the update, the losses. The port runs the same step in one
process per rank (``parallel.mesh.spawn``) with a ``DataCtx``, whose
collectives are those ``pmean``s: explicit ``all_reduce``s of one flat
tensor per net, not ``DistributedDataParallel`` (the GAN step freezes D for
the G head and averages D's grads before G's backward runs, which DDP's
hooks do not fit). Every rank builds the same state from --seed, so the
averaged grads keep the ranks' parameters bitwise equal.

The forward's batch statistics stay per rank, as in the JAX step (its
``Norm`` takes an axis name only under a spatial context): data parallelism
with batch norm is JAX's data-parallel step, not the one-device step on the
global batch. Under gloo (ranks sharing a card, or the CPU) the collectives
stage CUDA tensors through the host (``RankCtx``).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch import nn

from biasgan_tpu_torch.parallel.mesh import RankCtx


class DataCtx(RankCtx):
    """The data context of rank ``rank`` of ``n`` data ranks (the process
    group's ranks, in batch order). Build it on every rank at the same
    point; ``close`` likewise.

    ``grad_reduce_s``: the host seconds of each ``mean_grads_`` call, the
    card synchronized before and after (under gloo the staging copies
    synchronize it anyway)."""

    def __init__(self, n: int = 1, group=None):
        super().__init__(n, group)
        self.grad_reduce_s = []

    def _sync(self, params) -> None:
        if params and params[0].is_cuda:
            torch.cuda.synchronize(params[0].device)

    @torch.no_grad()
    def mean_grads_(self, params) -> None:
        """``RankCtx.mean_grads_``, timed into ``grad_reduce_s``."""
        params = list(params)
        self._sync(params)
        t0 = time.perf_counter()
        super().mean_grads_(params)
        self._sync(params)
        self.grad_reduce_s.append(time.perf_counter() - t0)

    @torch.no_grad()
    def mean_buffers_(self, net: nn.Module) -> None:
        """``net``'s floating-point buffers (the batch norms' running
        averages) replaced by their means over the ranks, in one
        ``all_reduce``; integer buffers (the batches counted) are the same
        on every rank and stay. A net without such buffers reduces
        nothing."""
        self._mean_flat_([b for b in net.buffers() if b.is_floating_point()])

    @torch.no_grad()
    def all_gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on the leading (batch) axis in
        rank order, on every rank (JAX ``all_gather`` of ``P("data")``
        shards, tiled); no autograd."""
        if self.size == 1:
            return t
        staged = self._staged(t)
        parts = [torch.empty_like(staged) for _ in range(self.size)]
        dist.all_gather(parts, staged, group=self.group)
        return torch.cat(parts).to(t.device)

    def rank_slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous slice of a global batch ``t`` (leading
        axis)."""
        b = t.shape[0] // self.size
        return t[self.rank * b:(self.rank + 1) * b]

    def close(self) -> None:
        """Every rank meets here before any leaves the group."""
        if self.size > 1:
            dist.barrier(group=self.group)
