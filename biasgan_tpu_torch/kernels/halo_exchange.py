"""Ring exchange of W halos between the ranks of a spatially sharded forward.

Counterpart of ``biasgan_tpu/ops/pallas_halo.py::halo_exchange_w`` (:96,
body ``_halo_kernel`` :44). Rank r of an n-rank ring sends the last ``left``
columns of its NHWC shard to rank r+1, which takes them as its left halo,
and its first ``right`` columns to rank r-1, which takes them as its right
halo. Where W is not periodic, the halos that cross the global edge are
zeros (pallas_halo.py:142-150).

``halo_exchange_w`` takes its plain version for a tensor on the CPU and
launches the CUDA kernel (csrc/halo_exchange.cu) for a CUDA tensor; there is
no fallback from one to the other. The plain version,
``halo_exchange_w_plain``, is the ``lax.ppermute`` path of the JAX
``HaloCtx.pad_w``: a ``torch.distributed.batch_isend_irecv`` ring. The
kernel writes both directions in one launch straight into the neighbours'
receive buffers, which each rank allocates once and the neighbours open
through CUDA IPC; then the ranks synchronise on the host (stream sync, group
barrier) and each reads its own buffers. ``halo_exchange_w.launches``
counts the kernel launches.

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
from typing import Optional, Tuple

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


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


class HaloRing:
    """Rank ``rank`` of a ring of ``n`` W shards (the process group's
    ranks, in order): its neighbours, the edge rule, and the kernel's
    receive buffers. Every rank of the group builds its ring at the same
    point, and calls ``close`` at the same point: both are collective where
    there is more than one rank, as is an exchange on the card that has to
    (re)allocate the buffers.

    ``via_host``: the group's backend is gloo, which takes no CUDA tensors,
    so the plain ring stages them through host copies."""

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
        self.via_host = distributed and dist.get_backend(group) == "gloo"
        # the kernel path's barriers and handle gathers run on the host, in
        # the group itself under gloo, else in a gloo group beside it
        self._host_sync = distributed and n > 1
        self._host_group = group
        if self._host_sync and not self.via_host:
            self._host_group = dist.new_group(backend="gloo")
        self.step = 0  # exchanges on the card so far (the ping-pong parity)
        self._slab: Optional[int] = None  # 4 buffers: left halo x2, right halo x2
        self._cap = 0  # bytes per buffer
        self._device: Optional[torch.device] = None
        self._peers = {}  # rank -> base of its opened slab

    def has_right(self) -> bool:
        """Whether this rank's right neighbour lies across no global edge
        (else what would cross it is zeros)."""
        return self.periodic or self.rank < self.n - 1

    def has_left(self) -> bool:
        return self.periodic or self.rank > 0

    def barrier(self) -> None:
        if self._host_sync:
            dist.barrier(group=self._host_group)

    # -- the kernel's receive buffers ------------------------------------

    @property
    def capacity(self) -> int:
        """Bytes per receive buffer (0 before the first exchange on the
        card)."""
        return self._cap

    def slab(self, peer: int) -> int:
        """Base address of ``peer``'s receive buffers in this process."""
        return self._slab if peer == self.rank else self._peers[peer]

    def ensure_buffers(self, nbytes: int, device: torch.device) -> int:
        """Receive buffers of at least ``nbytes`` each on ``device``, opened
        by both neighbours; returns the bytes per buffer."""
        if self._slab is not None:
            if device != self._device:
                raise ValueError(f"the ring's buffers are on {self._device}, x on {device}")
            if nbytes <= self._cap:
                return self._cap
            self._release()
        cap = 1 << max(MIN_BUFFER_BYTES.bit_length() - 1, (nbytes - 1).bit_length())
        lib = _lib()
        base, handle = ctypes.c_void_p(), ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        _check(lib.halo_buffer_alloc(device.index, 4 * cap, ctypes.byref(base), handle),
               f"allocating {4 * cap} bytes of receive buffers on {device}")
        self._slab, self._cap, self._device = base.value, cap, device
        handles = [handle.raw]
        if self._host_sync:
            handles = [None] * self.n
            dist.all_gather_object(handles, handle.raw, group=self._host_group)
        for peer in {self.left, self.right} - {self.rank}:
            opened = ctypes.c_void_p()
            _check(lib.halo_buffer_open(device.index, handles[peer], ctypes.byref(opened)),
                   f"rank {self.rank} opening rank {peer}'s receive buffers (CUDA IPC)")
            self._peers[peer] = opened.value
        return cap

    def _release(self) -> None:
        """Collective: every rank's reads are done and every neighbour has
        closed its mapping before a buffer is freed."""
        lib = _lib()
        torch.cuda.current_stream(self._device).synchronize()
        self.barrier()
        for peer, base in self._peers.items():
            _check(lib.halo_buffer_close(self._device.index, base), f"closing rank {peer}'s buffers")
        self._peers = {}
        self.barrier()
        _check(lib.halo_buffer_free(self._device.index, self._slab), "freeing the receive buffers")
        self._slab, self._cap = None, 0

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
        for f in (lib.halo_buffer_alloc, lib.halo_buffer_open, lib.halo_buffer_close,
                  lib.halo_buffer_free):
            f.restype = INT
        lib.port_error_string.argtypes = [INT]
        lib.port_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().port_error_string(err).decode()
        raise RuntimeError(f"halo_exchange: {what} failed: CUDA error {err} ({msg})")


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
    rank ``to`` if ``sends``, and ``out`` is filled from rank ``frm`` if
    ``receives`` (else it keeps what it holds). Under gloo a CUDA tensor
    goes through host copies."""
    where = torch.device("cpu") if ring.via_host and like.is_cuda else like.device
    ops, landed = [], []
    for k, send, to, sends, out, frm, receives, tag in legs:
        if k == 0:
            continue
        if sends:
            ops.append(dist.P2POp(dist.isend, send.contiguous().to(where), to, ring.group, tag))
        if receives:
            buf = torch.empty(out.shape, dtype=like.dtype, device=where)
            ops.append(dist.P2POp(dist.irecv, buf, frm, ring.group, tag))
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


def launch_halo_kernel(x: torch.Tensor, left: int, right: int, ring: HaloRing) -> int:
    """The kernel's launch alone, on the current stream, with no
    synchronisation: this rank's halo columns into the neighbours' receive
    buffers of the next ping-pong parity, which it returns. Counted in
    ``halo_exchange_w.launches``. ``halo_exchange_w`` is the exchange; this
    is its first step, and what a kernel timing times."""
    n, h, w, c = x.shape
    es = x.element_size()
    rows, lbytes, rbytes = n * h, left * c * es, right * c * es
    cap = ring.ensure_buffers(rows * max(lbytes, rbytes), x.device)
    k = ring.step % 2  # ping-pong: a neighbour may still read the other pair
    ring.step += 1
    launch(
        "halo_exchange", "halo_exchange_launch", _LAUNCH_ARGS, x.device, ptr(x),
        ring.slab(ring.right) + k * cap if lbytes else None,
        ring.slab(ring.left) + (2 + k) * cap if rbytes else None,
        rows, w * c * es, lbytes, rbytes, int(not ring.has_right()),
        int(not ring.has_left()),
    )
    halo_exchange_w.launches += 1
    return k


def _exchange(x, left, right, ring: HaloRing):
    n, h, w, c = x.shape
    es, dev = x.element_size(), x.device
    k = launch_halo_kernel(x, left, right, ring)
    # every rank's writes have landed once every rank has synced and met
    torch.cuda.current_stream(dev).synchronize()
    ring.barrier()
    lh = torch.empty((n, h, left, c), dtype=x.dtype, device=dev)
    rh = torch.empty((n, h, right, c), dtype=x.dtype, device=dev)
    own, cap = ring.slab(ring.rank), ring.capacity
    launch(
        "halo_exchange", "halo_read", _READ_ARGS, dev,
        ptr(lh), own + k * cap, n * h * left * c * es,
        ptr(rh), own + (2 + k) * cap, n * h * right * c * es,
    )
    return lh, rh


def halo_exchange_w(
    x: torch.Tensor, left: int, right: int, ring: HaloRing
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W halos of this rank's NHWC shard ``x`` (N, H, W_local, C), any
    dtype: ``(left_halo (N, H, left, C), right_halo (N, H, right, C))``,
    what ``HaloCtx.pad_w`` concatenates around x. Collective: every rank of
    ``ring`` calls it with the same shapes.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``halo_exchange_w.launches``) or raises. Inference only:
    it raises where autograd records."""
    _check_args(x, left, right)
    refuse_grad("halo_exchange_w", "inference only, as in JAX", x)
    if check_device("halo_exchange_w", x, []):
        return halo_exchange_w_plain(x, left, right, ring)
    if not x.is_contiguous():
        raise ValueError("halo_exchange_w kernel needs a contiguous NHWC x")
    return _exchange(x, left, right, ring)


halo_exchange_w.launches = 0
