"""Process groups for spatial sharding and data parallelism: one process
per W shard, per data rank, or per (data, spatial) cell of a 2-D mesh.

Counterpart of ``biasgan_tpu/parallel/mesh.py``. Where JAX runs the shards
as one SPMD program over a device mesh, the port runs one process per rank
on ``torch.distributed``:

* placement: with a CUDA device, rank r runs on ``cuda:(r % device_count)``
  (so N ranks on a one-card host all share ``cuda:0``); otherwise on the CPU;
* backend: NCCL when every rank has a card of its own; gloo otherwise (NCCL
  refuses two ranks on one device, and the CPU has only gloo). Under gloo
  the collectives on CUDA tensors go through explicit host copies
  (``parallel/spatial.py``). This is a transport choice, not a kernel
  fallback: the halo kernel runs under either, device-signalled where every
  rank has a card of its own, host-synchronised where ranks share one
  (``halo_route``);
* the 2-D mesh (``mesh_groups``): world rank r is (d, s) = divmod(r, S),
  the row-major order of JAX ``make_mesh(data, spatial)``; the spatial
  group of data index d is its row (the W shards' halos, moments and
  gathers), the data group of spatial index s its column (the batch
  gathers of the pools and the metrics);
* ``RankCtx``: what the spatial context (``parallel/spatial.py``) and the
  data context (``parallel/data_parallel.py``) share: this rank of its
  group (the world, or a row or column of the mesh), where the group's
  collectives take a tensor, the sums and means over the ranks without
  autograd, the mean of the grads and of the running averages, and the
  bitwise check;
* ``spawn`` starts the ranks (``torch.multiprocessing``, start method
  ``spawn``), each on a fresh ``file://`` rendezvous with an explicit group
  timeout, forwards rank 0's messages as they come, and returns rank 0's
  result. It raises if any rank fails, and if the ranks outlive the join
  timeout it kills them and raises.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 600.0  # a collective that waits this long has lost a rank


def rank_device(rank: int, device: str) -> torch.device:
    """Where rank ``rank`` runs when the run asks for ``device``."""
    if torch.device(device).type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(f"--device {device}: no CUDA device is visible")
        return torch.device("cuda", rank % count)
    return torch.device("cpu")


def backend_for(n: int, device: str) -> str:
    """NCCL when each of ``n`` ranks (the world's, a 2-D mesh's sub-groups
    included) has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def halo_route(n: int, device: str) -> str:
    """The route the halo kernel's exchanges take on ``n`` ranks placed by
    ``rank_device`` (``kernels/halo_exchange.py``; the ring decides it from
    the ranks' devices and checks the peers at its first exchange): 'cpu'
    (no kernel: its plain version), 'self', 'signalled' or 'host'."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if n == 1:
        return "self"
    return "signalled" if torch.cuda.device_count() >= n else "host"


HALO_ROUTES = {
    "cpu": "the point-to-point ring (the halo kernel's plain version on the CPU)",
    "self": "a self-ring on the card, ordered by its stream (no host sync)",
    "signalled": ("device-signalled: flags in each rank's CUDA IPC buffers over NVLink, "
                  "no host sync per exchange"),
    "host": ("host-synchronised: ranks share a card, so each exchange syncs the stream "
             "and meets the other ranks at a barrier"),
}


def placement(n: int, device: str, halo_rdma: bool = False, kind: str = "spatial",
              spatial: int = 1) -> str:
    """The one-line notice of where ``n`` ranks run and how they talk (with
    ``halo_rdma``, also the route of the halo kernel's exchanges); ``kind``
    ('spatial', 'data' or 'mesh') starts the line. A 'mesh' of ``n`` ranks
    is data n / spatial x ``spatial``, each rank named with its (d, s)."""
    backend = backend_for(n, device)
    if kind == "mesh":
        devices = ", ".join(f"{r}->{divmod(r, spatial)}->{rank_device(r, device)}"
                            for r in range(n))
        line = (f"mesh: data {n // spatial} x spatial {spatial} (rank->(d, s)->device "
                f"{devices}), backend {backend}")
    else:
        devices = ", ".join(f"{r}->{rank_device(r, device)}" for r in range(n))
        line = f"{kind}: {n} rank(s) (rank->device {devices}), backend {backend}"
    if backend == "gloo" and torch.device(device).type == "cuda":
        line += ("; ranks share a card, so collectives on CUDA tensors go through "
                 "host copies")
    if halo_rdma:
        line += f"; halos: {HALO_ROUTES[halo_route(n, device)]}"
    return line


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def mesh_groups(data: int, spatial: int) -> tuple:
    """This rank's (data group, spatial group) in a ``data`` x ``spatial``
    mesh of the world's ranks: world rank r is (d, s) = divmod(r,
    ``spatial``), row-major as JAX ``make_mesh(data, spatial)``; the
    spatial group is row d, the data group column s. Collective: every
    rank creates every group, the rows and then the columns, as torch
    requires."""
    if dist.get_world_size() != data * spatial:
        raise ValueError(f"a {data} x {spatial} mesh in a world of {dist.get_world_size()}")
    d, s = divmod(dist.get_rank(), spatial)
    rows = [dist.new_group(list(range(i * spatial, (i + 1) * spatial))) for i in range(data)]
    cols = [dist.new_group(list(range(j, data * spatial, spatial))) for j in range(spatial)]
    return cols[s], rows[d]


class RankCtx:
    """One rank of ``size`` ranks of a process group (``group``; None: the
    world), each its own process. Build it on every rank at the same point.
    ``rank`` is this process's rank in the group; ``root`` the world's
    number of the group's rank 0.

    ``via_host``: the group's backend is gloo, which takes no CUDA tensors,
    so the collectives stage them through host copies (``_staged``)."""

    def __init__(self, size: int = 1, group=None):
        distributed = _distributed()
        if size > 1 and not distributed:
            raise RuntimeError(f"{size} ranks need torch.distributed initialised, one "
                               "process per rank")
        if distributed and dist.get_world_size(group) != size:
            raise ValueError(f"{size} ranks in a group of {dist.get_world_size(group)}")
        self.size, self.group = size, group
        self.rank = dist.get_rank(group) if distributed else 0
        self.root = 0 if group is None else dist.get_global_rank(group, 0)
        self.via_host = distributed and dist.get_backend(group) == "gloo"

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` where the group's collectives take it."""
        return t.detach().to("cpu" if self.via_host else t.device, copy=True).contiguous()

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, with no autograd (a new tensor
        on t's device)."""
        staged = self._staged(t)
        dist.all_reduce(staged, group=self.group)
        return staged.to(t.device)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks, with no autograd (the step's
        losses, ``pmean``)."""
        return t if self.size == 1 else self._sum(t) / self.size

    def _mean_flat_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each of ``tensors`` (of one dtype) replaced in place by its mean
        over the ranks, in one ``all_reduce`` of them all, flattened."""
        if self.size == 1 or not tensors:
            return
        flat = self._sum(torch.cat([t.reshape(-1) for t in tensors])) / self.size
        for t, m in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(m.view_as(t))

    @torch.no_grad()
    def mean_grads_(self, params: Sequence[torch.nn.Parameter]) -> None:
        """Each parameter's ``.grad`` replaced by its mean over the ranks
        (a missing grad counts as zeros), in one ``all_reduce``: ``pmean``
        of the JAX step's grads. Every rank then holds the same grads."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._mean_flat_([p.grad for p in params])

    @torch.no_grad()
    def mean_buffers_(self, net: torch.nn.Module) -> None:
        """``net``'s floating-point buffers (the batch norms' running
        averages) replaced by their means over the ranks, in one
        ``all_reduce``; integer buffers (the batches counted) are the same
        on every rank and stay. A net without such buffers reduces
        nothing."""
        self._mean_flat_([b for b in net.buffers() if b.is_floating_point()])

    def same_on_every_rank(self, t: torch.Tensor) -> bool:
        """Whether ``t`` is bitwise the group's rank 0's on every rank
        (collective)."""
        mine = self._staged(t)
        ref = mine.clone()
        dist.broadcast(ref, src=self.root, group=self.group)
        every = [None] * self.size
        dist.all_gather_object(every, torch.equal(mine, ref), group=self.group)
        return all(every)


def _entry(rank, fn, n, args, device, init_method, group_timeout, queue):
    """One rank: join the group, run ``fn(rank, n, device, say, *args)``,
    send rank 0's result to the parent, leave the group."""
    dev = rank_device(rank, device)
    backend = backend_for(n, device)
    # the ranks share the host's cores: each takes its share, so the CPU
    # ops' thread pools (host-staged collectives) do not oversubscribe them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=group_timeout), **kw,
    )
    try:
        say = (lambda msg: queue.put(("msg", msg))) if rank == 0 else (lambda msg: None)
        result = fn(rank, n, dev, say, *args)
        if rank == 0:
            queue.put(("result", result))
    finally:
        dist.destroy_process_group()


def spawn(
    fn: Callable,
    n: int,
    args: Sequence = (),
    device: str = "cpu",
    timeout: Optional[float] = None,
    group_timeout: float = GROUP_TIMEOUT_S,
    on_message: Callable[[str], Any] = print,
):
    """Run ``fn(rank, n, device, say, *args)`` in ``n`` spawned processes,
    one per rank of a fresh process group, and return rank 0's result.
    ``fn`` must be importable (a module-level function); ``args`` and the
    result are pickled, so pass numpy arrays rather than tensors. ``say``
    sends a line from rank 0 to ``on_message`` in this process as it comes
    (the other ranks' ``say`` drops it).

    Raises what the first failing rank raised (``torch.multiprocessing``
    ``ProcessRaisedException``, with its traceback) or how it exited, and
    ``TimeoutError`` when the ranks run past ``timeout`` seconds (None:
    as long as every rank lives; a collective that waits past
    ``group_timeout`` fails its rank)."""
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    rendezvous = tempfile.mkdtemp(prefix="ranks_rdv_")
    init_method = "file://" + os.path.join(rendezvous, "group")
    procs = mp.start_processes(
        _entry, args=(fn, n, tuple(args), device, init_method, group_timeout, queue),
        nprocs=n, join=False, start_method="spawn",
    )
    deadline = None if timeout is None else time.monotonic() + timeout
    results = []

    def drain():
        # rank 0 blocks in put() until its message is read: read before join
        while not queue.empty():
            kind, value = queue.get()
            if kind == "msg":
                on_message(value)
            else:
                results.append(value)

    try:
        while True:
            drain()
            if procs.join(timeout=0.1):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks of {fn.__name__} still running after {timeout} s")
        drain()
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(rendezvous, ignore_errors=True)
    if not results:
        raise RuntimeError(f"{fn.__name__}: rank 0 returned no result")
    return results[0]
