"""Process groups for spatial sharding: one process per W shard.

Counterpart of ``biasgan_tpu/parallel/mesh.py``. Where JAX runs the shards
as one SPMD program over a device mesh, the port runs one process per shard
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
    """NCCL when each of ``n`` ranks has a card of its own, else gloo."""
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


def placement(n: int, device: str, halo_rdma: bool = False) -> str:
    """The one-line notice of where ``n`` ranks run and how they talk (with
    ``halo_rdma``, also the route of the halo kernel's exchanges)."""
    devices = ", ".join(f"{r}->{rank_device(r, device)}" for r in range(n))
    backend = backend_for(n, device)
    line = f"spatial: {n} rank(s) (rank->device {devices}), backend {backend}"
    if backend == "gloo" and torch.device(device).type == "cuda":
        line += ("; ranks share a card, so collectives on CUDA tensors go through "
                 "host copies")
    if halo_rdma:
        line += f"; halos: {HALO_ROUTES[halo_route(n, device)]}"
    return line


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
    rendezvous = tempfile.mkdtemp(prefix="spatial_rdv_")
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
                raise TimeoutError(f"{n} spatial ranks still running after {timeout} s")
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
