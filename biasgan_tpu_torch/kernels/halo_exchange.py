"""Ring exchange of W halos between the ranks of a spatially sharded forward.

Counterpart of ``biasgan_tpu/ops/pallas_halo.py::halo_exchange_w`` (:96,
body ``_halo_kernel`` :44). Rank r of an n-rank ring sends the last ``left``
columns of its NHWC shard to rank r+1, which takes them as its left halo,
and its first ``right`` columns to rank r-1, which takes them as its right
halo. Where W is not periodic, the halos that cross the global edge are
zeros (pallas_halo.py:142-150).

``halo_exchange_w`` takes its plain version for a tensor on the CPU and
launches the CUDA kernels (csrc/halo_exchange.cu) for a CUDA tensor; there
is no fallback from one to the other. The plain version,
``halo_exchange_w_plain``, is the ``lax.ppermute`` path of the JAX
``HaloCtx.pad_w``: a ``torch.distributed.batch_isend_irecv`` ring. On the
card each rank allocates a receive slab once, which the neighbours open
through CUDA IPC, and the ring decides its route when it sets the slab up
(``choose_route``):

* signalled, where every rank has a card of its own and reaches both
  neighbours' cards (NVLink): two launches, a send straight into the
  neighbours' slabs and a receive out of its own, ordered on the device by
  counters in the slabs (``SignalSeq`` computes what each waits for), with
  no host synchronisation; as the TPU kernel, whose receiver waits on its
  own DMA semaphores. Distinct cards that cannot reach each other raise;
* host-synchronised, where ranks share a card and so run in time slices,
  in which a kernel spinning on a flag could wait out a whole slice: one
  launch writes into the neighbours' slabs, then the ranks synchronise on
  the host (stream sync, group barrier) and each reads its own slots;
* self, a ring of one rank: the kernel writes its own slots, and stream
  order is all the synchronisation it needs.

``halo_exchange_w.launches`` counts the exchanges on the card,
``halo_exchange_w.signalled`` those that took the signalled route, and
``HaloRing.host_syncs`` the stream syncs and barriers the rings of this
process made on the card (in exchanges, and around a slab that is freed).

The plain ring is differentiable, as ``ppermute`` is in JAX: where autograd
records, ``halo_exchange_w_plain`` goes through a ``torch.autograd.Function``
whose backward is the reverse ring (the transpose of ``ppermute``,
``biasgan_tpu/parallel/spatial.py:73-97``): the cotangent of a left halo goes
back to the left neighbour, which adds it onto its last ``left`` columns, and
that of a right halo to the right neighbour, onto its first ``right``
columns; a cotangent of a global-edge halo that nobody sent is dropped. The
kernel is inference only, as in JAX: ``halo_exchange_w`` refuses to run where
autograd records.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from biasgan_tpu_torch.kernels.common import (
    INT,
    PTR,
    check_device,
    launch,
    ptr,
    refuse_grad,
    wants_grad,
)

# the two directions' messages, told apart where two ranks exchange both
TAG_RIGHTWARD, TAG_LEFTWARD = 1, 2
IPC_HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)
MIN_BUFFER_BYTES = 1 << 20
NTHREADS = 256  # threads per block of the kernels (csrc/halo_exchange.cu)
# blocks per direction of a signalled launch, at most: a few rings' kernels
# on one card (the loopback check) stay co-resident, and 64 blocks keep an
# NVLink direction busy at these sizes
SIGNAL_BLOCKS = 64
BLOCK_BYTES = NTHREADS * 16  # what one block moves per pass at 16-byte access


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def choose_route(devices: Sequence[int], rank: int,
                 can_access_peer: Callable[[int, int], bool]) -> str:
    """The route of rank ``rank``'s exchanges, from the CUDA device of
    every rank of the ring (``devices``): 'self' for one rank; 'signalled'
    where every rank is on a device of its own and this rank's device can
    reach both neighbours' (``can_access_peer(mine, theirs)``), raising if
    it cannot; else 'host' (ranks share a card)."""
    n = len(devices)
    if n == 1:
        return "self"
    if len(set(devices)) < n:
        return "host"
    mine = devices[rank]
    for peer in sorted({(rank - 1) % n, (rank + 1) % n}):
        if not can_access_peer(mine, devices[peer]):
            raise RuntimeError(
                f"halo_exchange_w: every rank has a card of its own, but rank {rank} "
                f"on cuda:{mine} cannot reach rank {peer}'s cuda:{devices[peer]} (no "
                "peer access with native atomics, as NVLink gives): the device-signalled "
                "exchange needs it, and the host-synchronised one is for ranks sharing a card"
            )
    return "signalled"


def signal_blocks(nbytes: int) -> int:
    """Blocks of one direction of a signalled launch that moves ``nbytes``:
    the same on every rank for the same shapes, whatever each rank's
    access width."""
    return min(SIGNAL_BLOCKS, -(-nbytes // BLOCK_BYTES))


class SignalStep(NamedTuple):
    """One signalled exchange, per direction as (left halos, right halos):
    the slot it writes and reads, the blocks of each launch, the counts of
    this rank's FREED words its send waits for (the slot it overwrites has
    been read), and those of its ARRIVE words its receive waits for (the
    slot holds this exchange's halos)."""

    slot: int
    blocks: Tuple[int, int]
    freed: Tuple[int, int]
    arrived: Tuple[int, int]


class SignalSeq:
    """Where one rank's signalled exchanges stand on one slab, whose flag
    counters start at 0. Each block of a launch adds 1 to one counter, and
    every rank launches the same blocks (the exchange is collective): so
    after exchange e a neighbour's adds have brought a counter to the sum
    of the blocks of exchanges 0..e of its direction. A slot is written at
    every other exchange, so a send waits for the reads of exchange e - 2."""

    def __init__(self):
        self.step = 0
        # blocks per direction summed over exchanges 0..e-2 and 0..e-1
        self._through = [(0, 0), (0, 0)]

    def next(self, bytes_l: int, bytes_r: int) -> SignalStep:
        """The next exchange, moving ``bytes_l`` of left halos and
        ``bytes_r`` of right halos."""
        blocks = (signal_blocks(bytes_l), signal_blocks(bytes_r))
        two_ago, last = self._through
        now = (last[0] + blocks[0], last[1] + blocks[1])
        step = SignalStep(self.step % 2, blocks, two_ago, now)
        self._through = [last, now]
        self.step += 1
        return step


class Slabs(NamedTuple):
    """The receive slabs a signalled exchange touches, as this process
    addresses them: this rank's and its left and right neighbours' bases,
    and the bytes per buffer."""

    own: int
    left: int
    right: int
    cap: int


class HaloRing:
    """Rank ``rank`` of a ring of ``n`` W shards (the process group's
    ranks, in order): its neighbours, the edge rule, and the kernel's
    receive slab. Every rank of the group builds its ring at the same
    point, and calls ``close`` at the same point: both are collective where
    there is more than one rank, as is an exchange on the card that has to
    (re)allocate the slab.

    ``via_host``: the group's backend is gloo, which takes no CUDA tensors,
    so the plain ring stages them through host copies. ``route``: the
    exchanges' route on the card (module docstring), decided at the slab's
    setup (None before the first exchange on the card)."""

    host_syncs = 0  # stream syncs and barriers made on the card, every ring of this process

    def __init__(self, n: int, periodic: bool = True, group=None):
        if n < 1:
            raise ValueError(f"a ring needs at least one shard, got {n}")
        distributed = _distributed()
        if n > 1 and not distributed:
            raise RuntimeError(
                f"a ring of {n} shards needs torch.distributed initialised, one "
                "process per shard"
            )
        if distributed and dist.get_world_size(group) != n:
            raise ValueError(
                f"a ring of {n} shards in a group of {dist.get_world_size(group)} ranks"
            )
        self.n, self.periodic, self.group = n, periodic, group
        self.rank = dist.get_rank(group) if distributed else 0
        self.left, self.right = (self.rank - 1) % n, (self.rank + 1) % n
        # the world's numbers of the group's ranks: a point-to-point op
        # names its peer so
        self.ranks = (list(range(n)) if group is None or not distributed
                      else dist.get_process_group_ranks(group))
        self.via_host = distributed and dist.get_backend(group) == "gloo"
        # the slab's handle gathers and the host route's barriers run on the
        # host, in the group itself under gloo, else in a gloo group of the
        # same ranks beside it (a sub-group's made by its members alone)
        self._host_sync = distributed and n > 1
        self._host_group = group
        if self._host_sync and not self.via_host:
            self._host_group = (
                dist.new_group(backend="gloo") if group is None else
                dist.new_group(self.ranks, backend="gloo", use_local_synchronization=True))
        self.route: Optional[str] = None
        self.step = 0  # host-route exchanges on this slab (the ping-pong parity)
        self.seq = SignalSeq()  # signalled exchanges on this slab
        self._slab: Optional[int] = None  # 4 buffers (left halo x2, right halo x2), flags
        self._cap = 0  # bytes per buffer
        self._device: Optional[torch.device] = None
        self._peers = {}  # rank -> base of its opened slab
        self._slabs: Optional[Slabs] = None  # what a signalled exchange touches

    def has_right(self) -> bool:
        """Whether this rank's right neighbour lies across no global edge
        (else what would cross it is zeros)."""
        return self.periodic or self.rank < self.n - 1

    def has_left(self) -> bool:
        return self.periodic or self.rank > 0

    def barrier(self) -> None:
        if self._host_sync:
            dist.barrier(group=self._host_group)

    def sync_host(self) -> None:
        """This rank's stream drained, then every rank met at a barrier:
        what was written into any slab has landed. Counted in
        ``host_syncs``."""
        torch.cuda.current_stream(self._device).synchronize()
        HaloRing.host_syncs += 1
        if self._host_sync:
            self.barrier()
            HaloRing.host_syncs += 1

    # -- the kernel's receive slab ----------------------------------------

    @property
    def capacity(self) -> int:
        """Bytes per receive buffer (0 before the first exchange on the
        card)."""
        return self._cap

    def slab(self, peer: int) -> int:
        """Base address of ``peer``'s receive slab in this process."""
        return self._slab if peer == self.rank else self._peers[peer]

    def slabs(self) -> Slabs:
        return self._slabs

    def ensure_buffers(self, nbytes: int, device: torch.device) -> int:
        """Receive buffers of at least ``nbytes`` each on ``device``, opened
        by both neighbours, and the route; returns the bytes per buffer. A
        new slab starts its flag counters, so its exchange count, at 0."""
        if self._slab is not None:
            if device != self._device:
                raise ValueError(f"the ring's buffers are on {self._device}, x on {device}")
            if nbytes <= self._cap:
                return self._cap
            self._release()
        cap = 1 << max(MIN_BUFFER_BYTES.bit_length() - 1, (nbytes - 1).bit_length())
        base, handle = alloc_slab(device, cap)
        self._slab, self._cap, self._device = base, cap, device
        self.step, self.seq = 0, SignalSeq()
        mine = (handle, device.index)
        every = [mine]
        if self._host_sync:
            every = [None] * self.n
            dist.all_gather_object(every, mine, group=self._host_group)
        self.route = choose_route([d for _, d in every], self.rank, can_access_peer)
        for peer in {self.left, self.right} - {self.rank}:
            opened = ctypes.c_void_p()
            _check(_lib().halo_buffer_open(device.index, every[peer][0], ctypes.byref(opened)),
                   f"rank {self.rank} opening rank {peer}'s receive buffers (CUDA IPC)")
            self._peers[peer] = opened.value
        self._slabs = Slabs(base, self.slab(self.left), self.slab(self.right), cap)
        return cap

    def _release(self) -> None:
        """Collective: every rank's reads are done and every neighbour has
        closed its mapping before a slab is freed."""
        self.sync_host()
        for peer, base in self._peers.items():
            _check(_lib().halo_buffer_close(self._device.index, base),
                   f"closing rank {peer}'s buffers")
        self._peers = {}
        self.barrier()
        free_slab(self._device, self._slab)
        self._slab, self._cap, self._slabs = None, 0, None

    def close(self) -> None:
        if self._slab is not None:
            self._release()


def _lib():
    from biasgan_tpu_torch.kernels import build

    lib = build.load("halo_exchange")
    if lib.halo_buffer_alloc.argtypes is None:
        lib.halo_buffer_alloc.argtypes = [INT, ctypes.c_size_t, PTR, PTR]
        lib.halo_buffer_open.argtypes = [INT, PTR, PTR]
        lib.halo_buffer_close.argtypes = [INT, PTR]
        lib.halo_buffer_free.argtypes = [INT, PTR]
        lib.halo_can_access_peer.argtypes = [INT, INT, PTR]
        for f in (lib.halo_buffer_alloc, lib.halo_buffer_open, lib.halo_buffer_close,
                  lib.halo_buffer_free, lib.halo_can_access_peer):
            f.restype = INT
        lib.halo_slab_bytes.argtypes = [ctypes.c_size_t]
        lib.halo_slab_bytes.restype = ctypes.c_size_t
        lib.port_error_string.argtypes = [INT]
        lib.port_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().port_error_string(err).decode()
        raise RuntimeError(f"halo_exchange: {what} failed: CUDA error {err} ({msg})")


def alloc_slab(device: torch.device, cap: int) -> Tuple[int, bytes]:
    """A zeroed receive slab of four ``cap``-byte buffers and the flag words
    on ``device``: (its base, its IPC handle)."""
    lib = _lib()
    base, handle = ctypes.c_void_p(), ctypes.create_string_buffer(IPC_HANDLE_BYTES)
    nbytes = lib.halo_slab_bytes(cap)
    _check(lib.halo_buffer_alloc(device.index, nbytes, ctypes.byref(base), handle),
           f"allocating {nbytes} bytes of receive buffers on {device}")
    return base.value, handle.raw


def free_slab(device: torch.device, base: int) -> None:
    _check(_lib().halo_buffer_free(device.index, base), "freeing the receive buffers")


def can_access_peer(device: int, peer: int) -> bool:
    """Whether CUDA device ``device`` reaches ``peer``'s memory with native
    atomics (NVLink)."""
    ok = ctypes.c_int()
    _check(_lib().halo_can_access_peer(device, peer, ctypes.byref(ok)),
           f"asking whether cuda:{device} reaches cuda:{peer}")
    return bool(ok.value)


def _check_args(x: torch.Tensor, left: int, right: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if left < 0 or right < 0:
        raise ValueError(f"halo widths must be >= 0, got ({left},{right})")
    if max(left, right) > x.shape[2]:
        raise ValueError(
            f"halo ({left},{right}) wider than local shard width {x.shape[2]}; "
            "use fewer shards or a wider field"
        )


def _swap(ring: HaloRing, like: torch.Tensor, legs) -> None:
    """One ``batch_isend_irecv`` of the ring's ``legs``, each ``(k, send,
    to, sends, out, frm, receives, tag)``: where ``k`` > 0, ``send`` goes to
    group rank ``to`` if ``sends``, and ``out`` is filled from group rank
    ``frm`` if ``receives`` (else it keeps what it holds). Under gloo a CUDA
    tensor goes through host copies."""
    where = torch.device("cpu") if ring.via_host and like.is_cuda else like.device
    ops, landed = [], []
    for k, send, to, sends, out, frm, receives, tag in legs:
        if k == 0:
            continue
        if sends:
            ops.append(dist.P2POp(dist.isend, send.contiguous().to(where), ring.ranks[to],
                                  ring.group, tag))
        if receives:
            buf = torch.empty(out.shape, dtype=like.dtype, device=where)
            ops.append(dist.P2POp(dist.irecv, buf, ring.ranks[frm], ring.group, tag))
            landed.append((out, buf))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    for out, buf in landed:
        out.copy_(buf)


def _ring(x: torch.Tensor, left: int, right: int, ring: HaloRing):
    n, h, w, c = x.shape
    lh, rh = x.new_zeros((n, h, left, c)), x.new_zeros((n, h, right, c))
    if ring.n == 1:  # a self-ring: wrap in place, or the zero pad
        if ring.periodic:
            lh.copy_(x[:, :, w - left:])
            rh.copy_(x[:, :, :right])
        return lh, rh
    _swap(ring, x, (
        (left, x[:, :, w - left:], ring.right, ring.has_right(), lh, ring.left,
         ring.has_left(), TAG_RIGHTWARD),
        (right, x[:, :, :right], ring.left, ring.has_left(), rh, ring.right,
         ring.has_right(), TAG_LEFTWARD),
    ))
    return lh, rh


def _reverse_ring(dlh: torch.Tensor, drh: torch.Tensor, shape, ring: HaloRing) -> torch.Tensor:
    """The adjoint of ``_ring``: the cotangent of x (of ``shape``) that the
    halos' cotangents give, each sent back to the rank it came from."""
    n, h, w, c = shape
    left, right = dlh.shape[2], drh.shape[2]
    last = dlh.new_zeros((n, h, left, c))  # the cotangent of x's last `left` columns
    first = drh.new_zeros((n, h, right, c))  # ... and of its first `right`
    if ring.n == 1:
        if ring.periodic:
            last.copy_(dlh)
            first.copy_(drh)
    else:
        _swap(ring, dlh, (
            (left, dlh, ring.left, ring.has_left(), last, ring.right, ring.has_right(),
             TAG_LEFTWARD),
            (right, drh, ring.right, ring.has_right(), first, ring.left, ring.has_left(),
             TAG_RIGHTWARD),
        ))
    dx = dlh.new_zeros(shape)
    dx[:, :, w - left:] += last
    dx[:, :, :right] += first
    return dx


class _RingExchange(torch.autograd.Function):
    """The plain ring under autograd: backward is the reverse ring."""

    @staticmethod
    def forward(ctx, x, left, right, ring):
        ctx.shape, ctx.ring = x.shape, ring
        return _ring(x, left, right, ring)

    @staticmethod
    def backward(ctx, dlh, drh):
        return _reverse_ring(dlh, drh, ctx.shape, ctx.ring), None, None, None


def halo_exchange_w_plain(
    x: torch.Tensor, left: int, right: int, ring: HaloRing
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``halo_exchange_w``: the halos by point-to-point
    messages (one ``batch_isend_irecv``), the global-edge halos of a
    non-periodic W as zeros that nobody sends (``ppermute``'s missing
    source). Under gloo a CUDA tensor goes through host copies. Where
    autograd records, its backward is the reverse ring (module docstring):
    collective as the forward is."""
    _check_args(x, left, right)
    if wants_grad(x):
        return _RingExchange.apply(x, left, right, ring)
    return _ring(x, left, right, ring)


_LAUNCH_ARGS = [PTR, PTR, PTR, INT, ctypes.c_longlong, INT, INT, INT, INT]
_READ_ARGS = [PTR, PTR, ctypes.c_size_t, PTR, PTR, ctypes.c_size_t]
_U64 = ctypes.c_ulonglong
_SEND_ARGS = [PTR, PTR, PTR, PTR, ctypes.c_size_t, INT, INT, ctypes.c_longlong, INT, INT,
              INT, INT, INT, INT, _U64, _U64]
_RECV_ARGS = [PTR, PTR, PTR, PTR, PTR, ctypes.c_size_t, INT, ctypes.c_longlong,
              ctypes.c_longlong, INT, INT, _U64, _U64]


def _row_bytes(x: torch.Tensor, left: int, right: int) -> Tuple[int, int, int]:
    """(rows N*H, bytes of the left and of the right halo per row)."""
    n, h, _, c = x.shape
    es = x.element_size()
    return n * h, left * c * es, right * c * es


def launch_halo_kernel(x: torch.Tensor, left: int, right: int, ring: HaloRing) -> int:
    """The host route's launch, on the current stream, with no
    synchronisation: this rank's halo columns into the neighbours' receive
    buffers of the next ping-pong parity, which it returns. Counted in
    ``halo_exchange_w.launches``. It is the first step of a host-route or
    self-ring exchange, and what a timing of that kernel alone times; on
    the signalled route a send waits on the neighbours' receives, so only
    whole exchanges run there, and this raises."""
    rows, lbytes, rbytes = _row_bytes(x, left, right)
    cap = ring.ensure_buffers(rows * max(lbytes, rbytes), x.device)
    if ring.route == "signalled":
        raise RuntimeError("launch_halo_kernel: the ring's route is signalled; a send "
                           "there waits on the neighbours' receives: run whole exchanges")
    k = ring.step % 2  # ping-pong: a neighbour may still read the other pair
    ring.step += 1
    launch(
        "halo_exchange", "halo_exchange_launch", _LAUNCH_ARGS, x.device, ptr(x),
        ring.slab(ring.right) + k * cap if lbytes else None,
        ring.slab(ring.left) + (2 + k) * cap if rbytes else None,
        rows, x.shape[2] * x.shape[3] * x.element_size(), lbytes, rbytes,
        int(not ring.has_right()), int(not ring.has_left()),
    )
    halo_exchange_w.launches += 1
    return k


def signal_send(x: torch.Tensor, left: int, right: int, step: SignalStep, slabs: Slabs,
                zero_l: bool, zero_r: bool, stream: torch.cuda.Stream) -> None:
    """The send of one signalled exchange on ``stream`` through ``slabs``
    (as this process addresses them: a ``HaloRing``'s IPC-opened ones, or
    the peers' own in a ring inside one process): this rank's last
    ``left`` columns of x into its right neighbour's left-halo slot, its
    first ``right`` into its left neighbour's right-halo slot (zeros where
    ``zero_l`` / ``zero_r``), each block after the slot's last read and
    before its ARRIVE add. x must be ready on ``stream``; ``signal_recv``
    follows on the same stream."""
    n, h, w, c = x.shape
    es = x.element_size()
    launch(
        "halo_exchange", "halo_signal_send", _SEND_ARGS, x.device, x.data_ptr(), slabs.own,
        slabs.left, slabs.right, slabs.cap, step.slot, n * h, w * c * es, left * c * es,
        right * c * es, int(zero_l), int(zero_r), *step.blocks, *step.freed, stream=stream,
    )


def signal_recv(lh: torch.Tensor, rh: torch.Tensor, step: SignalStep, slabs: Slabs,
                stream: torch.cuda.Stream) -> None:
    """The receive of one signalled exchange on ``stream``, after its send:
    this rank's slots into ``lh`` and ``rh`` once they hold this exchange's
    halos, each block then adding to the sender's FREED word."""
    launch(
        "halo_exchange", "halo_signal_recv", _RECV_ARGS, lh.device, lh.data_ptr(),
        rh.data_ptr(), slabs.own, slabs.left, slabs.right, slabs.cap, step.slot,
        lh.numel() * lh.element_size(), rh.numel() * rh.element_size(), *step.blocks,
        *step.arrived, stream=stream,
    )


def _exchange(x, left, right, ring: HaloRing):
    rows, lbytes, rbytes = _row_bytes(x, left, right)
    dev = x.device
    ring.ensure_buffers(rows * max(lbytes, rbytes), dev)
    n, h, _, c = x.shape
    if ring.route == "signalled":  # the send, then the receive: no host sync
        step, stream = ring.seq.next(rows * lbytes, rows * rbytes), torch.cuda.current_stream(dev)
        lh = torch.empty((n, h, left, c), dtype=x.dtype, device=dev)
        rh = torch.empty((n, h, right, c), dtype=x.dtype, device=dev)
        signal_send(x, left, right, step, ring.slabs(), not ring.has_right(),
                    not ring.has_left(), stream)
        signal_recv(lh, rh, step, ring.slabs(), stream)
        halo_exchange_w.launches += 1
        halo_exchange_w.signalled += 1
        return lh, rh
    k = launch_halo_kernel(x, left, right, ring)
    if ring.route == "host":  # every rank's writes have landed once every rank has synced and met
        ring.sync_host()
    lh = torch.empty((n, h, left, c), dtype=x.dtype, device=dev)
    rh = torch.empty((n, h, right, c), dtype=x.dtype, device=dev)
    own, cap = ring.slab(ring.rank), ring.capacity
    launch(
        "halo_exchange", "halo_read", _READ_ARGS, dev,
        ptr(lh), own + k * cap, rows * lbytes, ptr(rh), own + (2 + k) * cap, rows * rbytes,
    )
    return lh, rh


def halo_exchange_w(
    x: torch.Tensor, left: int, right: int, ring: HaloRing
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W halos of this rank's NHWC shard ``x`` (N, H, W_local, C), any
    dtype: ``(left_halo (N, H, left, C), right_halo (N, H, right, C))``,
    what ``HaloCtx.pad_w`` concatenates around x. Collective: every rank of
    ``ring`` calls it with the same shapes.

    A CPU tensor takes the plain version; a CUDA tensor runs the kernels on
    the ring's route (counted in ``halo_exchange_w.launches``, and in
    ``.signalled`` on the signalled route) or raises. Inference only: it
    raises where autograd records."""
    _check_args(x, left, right)
    refuse_grad("halo_exchange_w", "inference only, as in JAX", x)
    if check_device("halo_exchange_w", x, []):
        return halo_exchange_w_plain(x, left, right, ring)
    if not x.is_contiguous():
        raise ValueError("halo_exchange_w kernel needs a contiguous NHWC x")
    return _exchange(x, left, right, ring)


halo_exchange_w.launches = 0
halo_exchange_w.signalled = 0


def halo_counts(ring: HaloRing) -> dict:
    """This process's exchange counts on the card and ``ring``'s route
    (None before its first exchange on the card)."""
    return {"route": ring.route, "exchanges": halo_exchange_w.launches,
            "signalled": halo_exchange_w.signalled, "host_syncs": HaloRing.host_syncs}
