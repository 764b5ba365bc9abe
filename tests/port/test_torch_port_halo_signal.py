"""The halo exchange's signalled route (biasgan_tpu_torch/kernels/
halo_exchange.py, csrc/halo_exchange.cu) without a card.

* A model of N ranks' flag counters and slots, each rank a stream of
  kernels (a send, then a receive, per exchange), each kernel a set of
  blocks that wait, copy and signal as the CUDA blocks do, with the very
  ``SignalSeq`` the wrapper uses for every slot, block count and wait
  target. A ``hypothesis`` search over the interleavings of the blocks of
  every rank checks, for n in {2, 3, 4}, periodic or not, with left and
  right halos of zero width or not: no slot is overwritten before its
  reader has read it, every read sees its own exchange's data (the
  sender's, or zeros across a non-periodic global edge), and no schedule
  deadlocks, across a slab reallocation too (every rank drains its stream
  and meets a barrier, the new slab's counters start at 0, and so does
  the ring's ``SignalSeq``). A ``SignalSeq`` whose sends do not wait is
  caught overwriting an unread slot.
* The route: ``choose_route`` on faked topologies, and the wrapper's
  dispatch on each route with the launches faked.
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from biasgan_tpu_torch.kernels import halo_exchange as hx
from biasgan_tpu_torch.kernels.halo_exchange import (
    BLOCK_BYTES,
    SIGNAL_BLOCKS,
    HaloRing,
    SignalSeq,
    choose_route,
    signal_blocks,
)

L, R = 0, 1  # directions: the left halos (they travel rightward), the right halos


class ProtocolError(AssertionError):
    pass


class Model:
    """``n`` ranks running ``exchanges`` (each ``(bytes_l, bytes_r)``, the
    same on every rank: the exchange is collective), with a slab
    reallocation before each exchange index in ``reallocs``. Per rank:
    ARRIVE and FREED counters per direction, two slots per direction, each
    a dict chunk -> tag of what was written there."""

    def __init__(self, n, periodic, exchanges, reallocs=(), seq=SignalSeq):
        self.n, self.periodic, self.seq_type = n, periodic, seq
        self.epoch = 0
        self._new_slabs()
        # each rank's program: ("send" | "recv", exchange) and ("realloc", e)
        self.program = []
        for e in range(len(exchanges)):
            if e in reallocs and e > 0:
                self.program.append(("realloc", e))
            self.program += [("send", e), ("recv", e)]
        self.exchanges = exchanges
        self.pc = [0] * n  # each rank's next op
        self.running = [None] * n  # each rank's kernel in flight: {block: stage}
        self.steps = [{} for _ in range(n)]  # exchange -> SignalStep, at launch
        self.reads = {}  # (epoch, rank, direction, exchange) -> blocks done reading

    def _new_slabs(self):
        n = self.n
        self.arrive = [[0, 0] for _ in range(n)]
        self.freed = [[0, 0] for _ in range(n)]
        self.slots = [[[{}, {}], [{}, {}]] for _ in range(n)]  # [rank][dir][slot]
        self.written = [[[None, None], [None, None]] for _ in range(n)]
        self.seqs = [self.seq_type() for _ in range(n)]

    # -- the kernels --------------------------------------------------------

    def _launch(self, r):
        """Rank r's next kernel begins (its blocks), as far as a kernel with
        no blocks (an exchange that moves nothing) ends at once."""
        while self.running[r] is None and self.pc[r] < len(self.program):
            kind, e = self.program[self.pc[r]]
            if kind == "realloc":
                return
            if kind == "send":
                self.steps[r][e] = self.seqs[r].next(*self.exchanges[e])
            step = self.steps[r][e]
            self.running[r] = {(d, b): 0 for d in (L, R) for b in range(step.blocks[d])}
            if not self.running[r]:
                self.running[r] = None
                self.pc[r] += 1

    def actions(self):
        """Every action that may run now."""
        out = []
        for r in range(self.n):
            self._launch(r)
        at_realloc = [self.pc[r] < len(self.program) and self.program[self.pc[r]][0] == "realloc"
                      for r in range(self.n)]
        if all(at_realloc):
            return [("realloc",)]
        for r in range(self.n):
            if self.pc[r] >= len(self.program) or at_realloc[r]:
                continue
            kind, e = self.program[self.pc[r]]
            step = self.steps[r][e]
            for (d, b), stage in self.running[r].items():
                if stage == 0 and self._may_go(r, kind, d, step):
                    out.append(("copy", r, d, b))
                elif stage == 1:
                    out.append(("signal", r, d, b))
        return out

    def _may_go(self, r, kind, d, step):
        if kind == "send":
            return self.freed[r][d] >= step.freed[d]
        return self.arrive[r][d] >= step.arrived[d]

    def _to(self, r, d):
        """The rank that rank r's direction-d halos go to."""
        return (r + 1) % self.n if d == L else (r - 1) % self.n

    def _from(self, r, d):
        return (r - 1) % self.n if d == L else (r + 1) % self.n

    def _zero(self, sender, d):
        """Whether sender's direction-d halos cross a non-periodic edge."""
        if self.periodic:
            return False
        return sender == self.n - 1 if d == L else sender == 0

    def run(self, act):
        if act[0] == "realloc":
            self.epoch += 1
            self._new_slabs()
            for r in range(self.n):
                self.pc[r] += 1
            return
        _, r, d, b = act
        kind, e = self.program[self.pc[r]]
        step = self.steps[r][e]
        k = step.slot
        if act[0] == "copy":
            if kind == "send":
                dst = self._to(r, d)
                prev = self.written[dst][d][k]  # (exchange, its blocks) last written there
                if prev is not None and prev[0] != e:
                    if self.reads.get((self.epoch, dst, d, prev[0]), 0) < prev[1]:
                        raise ProtocolError(
                            f"rank {r} overwrote rank {dst}'s slot {k} (direction {d}) of "
                            f"exchange {prev[0]} at exchange {e} before it was read")
                self.slots[dst][d][k][b] = (self.epoch, e, r, self._zero(r, d))
                self.written[dst][d][k] = (e, step.blocks[d])
            else:
                src = self._from(r, d)
                want = (self.epoch, e, src, self._zero(src, d))
                got = [self.slots[r][d][k].get(j) for j in range(step.blocks[d])]
                if any(g != want for g in got):
                    raise ProtocolError(f"rank {r} read {got} at exchange {e}, direction "
                                        f"{d}, expected {want}")
                key = (self.epoch, r, d, e)
                self.reads[key] = self.reads.get(key, 0) + 1
            self.running[r][(d, b)] = 1
            return
        # signal
        if kind == "send":
            self.arrive[self._to(r, d)][d] += 1
        else:
            self.freed[self._from(r, d)][d] += 1
        self.running[r][(d, b)] = 2
        if all(v == 2 for v in self.running[r].values()):
            self.running[r] = None
            self.pc[r] += 1

    def done(self):
        for r in range(self.n):
            self._launch(r)
        return all(pc == len(self.program) for pc in self.pc)


def drive(model, choose):
    """Run the model to its end, ``choose(n)`` picking one of n actions;
    raises ProtocolError on a violation or a deadlock."""
    for _ in range(100000):
        if model.done():
            return
        acts = model.actions()
        if not acts:
            raise ProtocolError(f"deadlock: ranks at ops {model.pc} of {len(model.program)}")
        model.run(acts[choose(len(acts))])
    raise ProtocolError("no end")


def _bytes(blocks, trim):
    """Bytes that signal_blocks turns into ``blocks`` blocks."""
    return 0 if blocks == 0 else blocks * BLOCK_BYTES - trim


exchange = st.tuples(st.integers(0, 3), st.integers(0, BLOCK_BYTES - 1),
                     st.integers(0, 3), st.integers(0, BLOCK_BYTES - 1)).map(
    lambda t: (_bytes(t[0], t[1]), _bytes(t[2], t[3])))


@pytest.mark.parametrize("n", [2, 3, 4])
@settings(max_examples=60, deadline=None)
@given(periodic=st.booleans(), exchanges=st.lists(exchange, min_size=1, max_size=6),
       reallocs=st.sets(st.integers(1, 5), max_size=2), data=st.data())
def test_signalled_protocol_holds_on_every_interleaving(n, periodic, exchanges, reallocs,
                                                        data):
    model = Model(n, periodic, exchanges, reallocs)
    drive(model, lambda k: data.draw(st.integers(0, k - 1)))


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("order", ["first", "last"])
def test_signalled_protocol_when_one_rank_runs_ahead(n, order):
    """A greedy schedule: always the first (or last) action, so the lowest
    (or highest) rank runs as far ahead as the counters let it, with an
    exchange that moves nothing between two that do."""
    exchanges = [(2 * BLOCK_BYTES, BLOCK_BYTES), (0, 0), (BLOCK_BYTES, 0),
                 (3 * BLOCK_BYTES, 3 * BLOCK_BYTES), (0, BLOCK_BYTES)]
    drive(Model(n, False, exchanges, reallocs={3}),
          (lambda k: 0) if order == "first" else (lambda k: k - 1))


def test_the_model_catches_a_send_that_does_not_wait():
    """With the sends' FREED targets taken away, the rank that runs ahead
    across an exchange that moves nothing overwrites a slot its neighbour
    has not read: the checks have teeth."""

    class NoWait(SignalSeq):
        def next(self, bytes_l, bytes_r):
            return super().next(bytes_l, bytes_r)._replace(freed=(0, 0))

    exchanges = [(BLOCK_BYTES, BLOCK_BYTES), (0, 0), (BLOCK_BYTES, BLOCK_BYTES)]
    drive(Model(2, True, exchanges), lambda k: 0)
    with pytest.raises(ProtocolError, match="overwrote"):
        drive(Model(2, True, exchanges, seq=NoWait), lambda k: 0)


def test_signal_seq_targets():
    """The slots alternate; a receive waits for every block sent so far, a
    send for every block read up to two exchanges back."""
    seq = SignalSeq()
    b = BLOCK_BYTES
    steps = [seq.next(*x) for x in [(b, 2 * b), (3 * b, 0), (b, b), (0, b)]]
    assert [s.slot for s in steps] == [0, 1, 0, 1]
    assert [s.blocks for s in steps] == [(1, 2), (3, 0), (1, 1), (0, 1)]
    assert [s.arrived for s in steps] == [(1, 2), (4, 2), (5, 3), (5, 4)]
    assert [s.freed for s in steps] == [(0, 0), (0, 0), (1, 2), (4, 2)]
    assert signal_blocks(0) == 0 and signal_blocks(1) == 1
    assert signal_blocks(10**9) == SIGNAL_BLOCKS


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------

def test_route_from_the_ranks_devices():
    """Distinct cards that reach each other: signalled; ranks sharing a
    card (what gloo serves, one card for four ranks): the host route; one
    rank: a self-ring; distinct cards with no peer access: raise."""
    every = lambda a, b: True  # noqa: E731
    assert choose_route([0], 0, every) == "self"
    for r in range(4):
        assert choose_route([0, 1, 2, 3], r, every) == "signalled"
        assert choose_route([0, 0, 0, 0], r, every) == "host"
    assert choose_route([0, 1, 0, 1], 1, every) == "host"
    asked = []
    choose_route([3, 0, 2, 1], 1, lambda a, b: asked.append((a, b)) or True)
    assert asked == [(0, 3), (0, 2)]  # both neighbours, from this rank's card
    # rank 2 cannot reach rank 3's card: rank 2 raises, rank 0 does not ask
    no_2_3 = lambda a, b: {a, b} != {2, 3}  # noqa: E731
    with pytest.raises(RuntimeError, match="rank 2 on cuda:2 cannot reach rank 3"):
        choose_route([0, 1, 2, 3], 2, no_2_3)
    assert choose_route([0, 1, 2, 3], 0, no_2_3) == "signalled"


@pytest.mark.parametrize("route", ["signalled", "host", "self"])
def test_exchange_dispatch_on_each_route(monkeypatch, route):
    """With the slab, the route and the launches faked: the signalled route
    launches a send and a receive (one exchange, counted in ``launches`` and
    ``signalled``) and syncs nothing on the host; the host route launches
    the copy, syncs the stream and meets the ranks (2 host syncs), then
    reads; the self-ring launches the copy and reads, with no host sync.
    The signalled targets advance exchange by exchange; the host route's
    kernel alone raises on the signalled route."""
    calls = []
    monkeypatch.setattr(hx, "alloc_slab", lambda device, cap: (1 << 40, b"\0" * 64))
    monkeypatch.setattr(hx, "choose_route", lambda devices, rank, peer: route)
    monkeypatch.setattr(hx, "launch", lambda name, fn, argtypes, device, *args, stream=None:
                        calls.append((fn, args)) or None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(HaloRing, "sync_host", lambda self: calls.append(("sync", ())) or
                        setattr(HaloRing, "host_syncs", HaloRing.host_syncs + 2))
    ring = HaloRing(1, periodic=True)
    x = torch.zeros((1, 4, 6, 8))
    before = (hx.halo_exchange_w.launches, hx.halo_exchange_w.signalled, HaloRing.host_syncs)
    for _ in range(3):
        lh, rh = hx._exchange(x, 2, 1, ring)
        assert lh.shape == (1, 4, 2, 8) and rh.shape == (1, 4, 1, 8)
    after = (hx.halo_exchange_w.launches, hx.halo_exchange_w.signalled, HaloRing.host_syncs)
    names = [fn for fn, _ in calls]
    assert ring.route == route
    if route == "signalled":
        assert names == ["halo_signal_send", "halo_signal_recv"] * 3
        assert after == (before[0] + 3, before[1] + 3, before[2])
        sends = [args for fn, args in calls if fn == "halo_signal_send"]
        slot, blocks, freed = [a[5] for a in sends], [a[12:14] for a in sends], \
            [a[14:16] for a in sends]
        assert slot == [0, 1, 0] and blocks == [(1, 1)] * 3
        assert freed == [(0, 0), (0, 0), (1, 1)]
        recvs = [args for fn, args in calls if fn == "halo_signal_recv"]
        assert [a[11:13] for a in recvs] == [(1, 1), (2, 2), (3, 3)]
        with pytest.raises(RuntimeError, match="route is signalled"):
            hx.launch_halo_kernel(x, 2, 1, ring)
        # a halo past the slab's buffers: every rank frees it (syncing on the
        # host) and sets up a larger one, whose counters and sequence restart
        monkeypatch.setattr(hx, "free_slab", lambda device, base: calls.append(("free", ())))
        calls.clear()
        big = torch.zeros((1, 1100, 6, 256))  # 1100 rows x 1 KB of left halo > 1 MB
        hx._exchange(big, 1, 0, ring)
        assert [fn for fn, _ in calls] == ["sync", "free", "halo_signal_send",
                                           "halo_signal_recv"]
        assert ring.capacity == 2 << 20
        send, recv = calls[2][1], calls[3][1]
        assert send[5] == 0 and send[12:16] == (64, 0, 0, 0) and recv[11:13] == (64, 0)
    elif route == "host":
        assert names == ["halo_exchange_launch", "sync", "halo_read"] * 3
        assert after == (before[0] + 3, before[1], before[2] + 6)
    else:
        assert names == ["halo_exchange_launch", "halo_read"] * 3
        assert after == (before[0] + 3, before[1], before[2])


def test_placement_names_the_halo_route(monkeypatch):
    """The startup notice of a sharded --halo_rdma run says which route the
    halos take: signalled with a card per rank, host-synchronised with
    ranks sharing a card, a self-ring for one rank, the plain ring on the
    CPU."""
    from biasgan_tpu_torch.parallel import mesh

    for cards, n, route in ((4, 4, "signalled"), (8, 4, "signalled"), (1, 4, "host"),
                            (2, 4, "host"), (1, 1, "self")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        assert mesh.halo_route(n, "cuda") == route
        line = mesh.placement(n, "cuda", halo_rdma=True)
        assert line.endswith("halos: " + mesh.HALO_ROUTES[route])
        assert "halos" not in mesh.placement(n, "cuda")
    assert mesh.halo_route(4, "cpu") == "cpu"
