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

In a 2-D mesh (``--data_mesh D --spatial_mesh S``, ``parallel.mesh.
mesh_groups``) the data context is the rank's column, the D ranks that
hold the same W shard of the D slices: its batch gathers (the pools, the
metrics) and its index (the draws, the dataset slice) are the column's,
while its means (the grads, the running averages, the losses) span every
rank of the mesh, as the JAX step ``pmean``s over ("data", "spatial").
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from biasgan_tpu_torch.parallel.mesh import RankCtx
from biasgan_tpu_torch.trace import span


class DataCtx(RankCtx):
    """The data context of rank ``rank`` of ``n`` data ranks (the process
    group's ranks, in batch order). Build it on every rank at the same
    point; ``close`` likewise.

    ``spatial``: the W shards beside each data rank in a 2-D mesh (the
    group is then the rank's column); ``mean``, ``mean_grads_`` and
    ``mean_buffers_`` then span all ``n * spatial`` ranks, the world
    (``mesh``).

    ``grad_reduces``: the ``mean_grads_`` calls so far (a step makes one
    a net); each runs in the span ``port.step.grad_reduce``."""

    def __init__(self, n: int = 1, group=None, spatial: int = 1):
        super().__init__(n, group)
        self.mesh = self if spatial == 1 else RankCtx(n * spatial)
        self.grad_reduces = 0

    @torch.no_grad()
    def mean_grads_(self, params) -> None:
        """``RankCtx.mean_grads_`` over the mesh's ranks, counted in
        ``grad_reduces``."""
        with span("port.step.grad_reduce"):
            RankCtx.mean_grads_(self.mesh, list(params))
        self.grad_reduces += 1

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the mesh's ranks (the losses)."""
        return RankCtx.mean(self.mesh, t)

    def mean_buffers_(self, net: nn.Module) -> None:
        """``RankCtx.mean_buffers_`` over the mesh's ranks."""
        RankCtx.mean_buffers_(self.mesh, net)

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
