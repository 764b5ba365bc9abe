"""The instance norm's forward as its CUDA kernel computes it
(biasgan_tpu_torch/kernels/csrc/instance_norm_act.cu, norm_kernel),
emulated in torch on the CPU from the wrapper's own plan (``norm_plan``):
tasks of an image and gb 16-byte channel groups, ``ranges`` blocks per
task over contiguous pixel ranges, the persistent grid's tasks in rounds,
f32 partial sums per block folded in range (cluster rank) order, the
reference's variance (mean^2 rounded before the subtraction), the last
``layers`` steps of each block held in shared memory and the earlier ones
read again newest first, and the apply with the residual added in f32 and
one cast.

The plan itself is checked at the globe's and the training step's shapes
and a sweep: every pixel of every (image, channel) in exactly one block,
shared memory within a block's 232,448 bytes, clusters of at most 8
blocks, the layer ring's invariants, and the path each shape takes. The
emulation is held to the wrapper's plain version (which the CPU takes) and,
at one tiny shape per path, to the JAX Pallas kernel in interpret mode, as
test_torch_port_instance_norm_act.py runs it. The card holds the kernel to
the plain version (test_torch_port_cuda.py, chip_smoke.py).

Tolerances: f32 1e-5, bf16 2e-2 of (1 + |ref|) on y (the residual added in
f32 and the result cast once in both); statistics f32 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.ops.pallas_fused import fused_instance_norm_act
from biasgan_tpu_torch.kernels import instance_norm_act as k7
from biasgan_tpu_torch.profile_norm import GLOBE_NORMS, train_norms

SMS = 132  # an H100's
ES = {torch.float32: 4, torch.bfloat16: 2}


@pytest.fixture(autouse=True)
def _one_thread():
    """The emulation's tensors are small: one thread runs them faster than
    a pool woken for every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cdiv(a, b):
    return -(-a // b)


def _blocks(plan, n, hw, c):
    """Every (round, block) of the plan's launch: (image, first channel,
    last channel, first pixel, last pixel, range) of the block's work, from
    the kernel's own index arithmetic."""
    groups = _cdiv(c, plan.vec)
    tasks = n * plan.cblocks
    if plan.path == "cluster":
        assert plan.grid == plan.ranges * plan.cblocks * n
        per_round, slots = tasks, [(b // plan.ranges, b % plan.ranges) for b in range(plan.grid)]
    else:
        per_round = plan.grid // plan.ranges
        slots = [(b // plan.ranges, b % plan.ranges) for b in range(plan.grid)]
    out = []
    for rnd in range(_cdiv(tasks, per_round)):
        for slot, r in slots:
            task = rnd * per_round + slot
            if slot >= per_round or task >= tasks:
                continue
            g0 = (task % plan.cblocks) * plan.gb
            gbb = min(plan.gb, groups - g0)
            p0 = r * plan.block_px
            out.append((task // plan.cblocks, g0 * plan.vec, min(c, (g0 + gbb) * plan.vec), p0,
                        min(hw, p0 + plan.block_px), r))
    return out


def emulate(x, residual, act, plan, eps=1e-5):
    """(y, stats, staged, reread): instance_norm_act the kernel's way under
    ``plan``, and per element how many times it was written from shared
    memory and from a second read of x."""
    n, h, w, c = x.shape
    hw = h * w
    xf = x.reshape(n, hw, c).float()
    rf = None if residual is None else residual.reshape(n, hw, c).float()
    y = torch.zeros((n, hw, c), dtype=x.dtype)
    stats = torch.zeros((2, n, c))
    staged = torch.zeros((n, hw, c), dtype=torch.int32)
    reread = torch.zeros((n, hw, c), dtype=torch.int32)
    by_task = {}
    for blk in _blocks(plan, n, hw, c):
        by_task.setdefault(blk[:3], []).append(blk[3:])
    for (i, c0, c1), ranges in by_task.items():
        ranges.sort(key=lambda b: b[2])
        lanes = k7.NTH // _cdiv(c1 - c0, plan.vec)
        s = q = None
        held = []
        for p0, p1, _ in ranges:  # pass 1: the block's f32 partials, folded in range order
            rows = xf[i, p0:p1, c0:c1]
            s = rows.sum(0) if s is None else s + rows.sum(0)
            q = rows.square().sum(0) if q is None else q + rows.square().sum(0)
            nsteps = _cdiv(p1 - p0, lanes)
            kept_from = min(p1, p0 + (nsteps - min(nsteps, plan.layers)) * lanes)
            held.append((p0, p1, kept_from, rows[kept_from - p0:].clone()))
        mean = s / hw
        var = torch.clamp(q / hw - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        stats[0, i, c0:c1], stats[1, i, c0:c1] = mean, inv

        def apply(rows, lo, hi):
            z = (rows - mean) * inv
            if rf is not None:
                z = z + rf[i, lo:hi, c0:c1]
            return k7.act_f32(z, act).to(x.dtype)

        for p0, p1, kept_from, kept in held:  # pass 2: the held steps, then the rest again
            y[i, kept_from:p1, c0:c1] = apply(kept, kept_from, p1)
            staged[i, kept_from:p1, c0:c1] += 1
            y[i, p0:kept_from, c0:c1] = apply(xf[i, p0:kept_from, c0:c1], p0, kept_from)
            reread[i, p0:kept_from, c0:c1] += 1
    return y.reshape(x.shape), stats, staged, reread


def _plan(shape, dtype, persistent=False, sms=SMS):
    n, h, w, c = shape
    return k7.norm_plan(n, h * w, c, ES[dtype], sms, persistent)


TRAIN_SHAPES = sorted({shape for shape, _, _, _ in train_norms()})
GLOBE_SHAPES = sorted({shape for shape, _, _, _ in GLOBE_NORMS})
SWEEP_SHAPES = [(2, 13, 37, 5), (2, 13, 37, 64), (2, 13, 37, 264), (2, 1, 1, 8),
                (2, 13, 37, 56), (40, 64, 64, 56)]


@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GLOBE_SHAPES + TRAIN_SHAPES + SWEEP_SHAPES)
def test_plan_covers_every_pixel_once_within_the_card(shape, dtype, persistent):
    """Every pixel of every (image, channel) in exactly one block's range
    (ranges tile H W, channel blocks tile C, rounds cover every task once);
    shared memory as the kernel lays it out and within a block's limit;
    clusters of at most CLUSTER_MAX blocks holding every step; a persistent
    grid of one block per SM, whose streamed ranges keep DEPTH steps in
    flight in a ring of more layers than that."""
    n, h, w, c = shape
    hw = h * w
    p = _plan(shape, dtype, persistent)
    assert p.vec == 16 // ES[dtype]
    assert p.smem == k7._scratch(p.vec, p.gb) + p.layers * k7.LAYER <= k7.SMEM_BLOCK
    assert p.gb & (p.gb - 1) == 0 and p.gb <= k7.GB_MAX
    assert (p.ranges - 1) * p.block_px < hw <= p.ranges * p.block_px
    if p.path == "cluster":
        assert not persistent and 1 <= p.ranges <= k7.CLUSTER_MAX and p.steps <= p.layers
    else:
        assert p.grid <= SMS and p.grid % p.ranges == 0
        assert p.steps <= p.layers or p.layers > 2 * k7.DEPTH + 1
    per_image = {}
    for i, c0, c1, p0, p1, _ in _blocks(p, n, hw, c):
        assert p0 < p1 and c0 < c1
        per_image.setdefault(i, []).append((c0, c1, p0, p1))
    assert sorted(per_image) == list(range(n))
    for blocks in per_image.values():
        chans = sorted({(c0, c1) for c0, c1, _, _ in blocks})
        assert [lo for lo, _ in chans] == [0] + [hi for _, hi in chans[:-1]]
        assert chans[-1][1] == c
        for cb in chans:
            spans = sorted((p0, p1) for c0, c1, p0, p1 in blocks if (c0, c1) == cb)
            assert [lo for lo, _ in spans] == [0] + [hi for _, hi in spans[:-1]]
            assert spans[-1][1] == hw


def test_paths_the_plan_names_at_the_main_shapes():
    """The globe's four norm shapes take the persistent path (no 32-byte
    slice of their planes fits a cluster); the training step's 256x256
    norms likewise, and every smaller one of the step the cluster path, in
    both dtypes; the largest cluster plans and the persistent ones pinned."""
    for dtype in (torch.bfloat16, torch.float32):
        for shape in GLOBE_SHAPES:
            assert _plan(shape, dtype).path == "persistent", shape
        for shape in TRAIN_SHAPES:
            want = "persistent" if shape[1] == 256 else "cluster"
            assert _plan(shape, dtype).path == want, (shape, dtype)
    assert _plan((1, 724, 1440, 64), torch.bfloat16) == k7.NormPlan(
        "persistent", 8, 8, 1, 132, 132, 7899, 26, 230400)
    assert _plan((1, 181, 360, 256), torch.bfloat16) == k7.NormPlan(
        "persistent", 8, 16, 2, 66, 132, 988, 26, 231424)
    assert _plan((3, 256, 256, 64), torch.bfloat16) == k7.NormPlan(
        "persistent", 8, 8, 1, 44, 132, 1490, 24, 214016)


def _data(shape, dtype, residual, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 1).astype(np.float32)).to(dtype)
    r = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype) if residual else None
    return x, r


def _close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    g, r = got.float(), want.float()
    assert bool(((g - r).abs() <= tol * (1 + r.abs())).all()), float((g - r).abs().max())


# small shapes on a card of few SMs, so that the persistent grid has several
# ranges per task and more tasks than blocks (rounds), blocks hold only
# their last steps (a 1,000-pixel range streams), and C is ragged
EMULATED = [((2, 13, 37, 5), 3), ((2, 13, 37, 64), 6), ((3, 9, 11, 264), 5),
            ((2, 1, 1, 8), 4), ((1, 100, 130, 16), 4)]


@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sms", EMULATED)
def test_emulated_kernel_matches_plain(shape, sms, dtype, persistent):
    """The emulation under the plan (every act, with and without the
    residual) against instance_norm_act_plain and the statistics against
    instance_norm_stats_plain; every element written once, from shared
    memory or from a second read of x as the plan's layers say."""
    p = _plan(shape, dtype, persistent, sms)
    for i, (act, res) in enumerate((("relu", False), ("none", True), ("lrelu", True))):
        x, r = _data(shape, dtype, res, seed=sum(shape) + i)
        y, stats, staged, reread = emulate(x, r, act, p)
        assert y.dtype == x.dtype
        _close(y, k7.instance_norm_act_plain(x, r, act), dtype)
        ref = k7.instance_norm_stats_plain(x)
        assert bool(((stats - ref).abs() <= 1e-5 * (1 + ref.abs())).all())
        assert bool(((staged + reread) == 1).all())
        assert bool((reread == 0).all()) == (p.steps <= p.layers)


def test_a_streamed_range_rereads_its_earlier_steps():
    """Where a block's range outgrows its layers (one SM for 13,000
    pixels), pass 2 reads the earlier steps again and only the last
    ``layers`` steps come from shared memory."""
    shape = (1, 100, 130, 16)
    p = _plan(shape, torch.float32, True, sms=1)
    assert p.steps > p.layers > 2 * k7.DEPTH + 1
    x, _ = _data(shape, torch.float32, False, seed=3)
    _, _, staged, reread = emulate(x, None, "relu", p)
    lanes = k7.NTH // p.gb
    assert int(staged[0, :, 0].sum()) == 130 * 100 - (p.steps - p.layers) * lanes
    assert int(reread.sum()) == (p.steps - p.layers) * lanes * 16


@pytest.mark.parametrize("persistent", [False, True])
def test_emulated_kernel_matches_jax_interpret(persistent):
    """At one tiny shape per path, the emulation against the JAX Pallas
    kernel in interpret mode (f32, with the residual)."""
    shape = (2, 6, 9, 16)
    p = _plan(shape, torch.float32, persistent, sms=3)
    assert p.path == ("persistent" if persistent else "cluster")
    x, r = _data(shape, torch.float32, True, seed=11)
    want = fused_instance_norm_act(jnp.asarray(x.numpy()), jnp.asarray(r.numpy()), "lrelu",
                                   1e-5, True, True)
    y, _, _, _ = emulate(x, r, "lrelu", p)
    _close(y, torch.from_numpy(np.array(want)), torch.float32)


def test_kernel_branch_passes_the_plan_and_counts_its_path(monkeypatch):
    """With the device check faked to the kernel branch and ctypes faked:
    one C call a forward, its arguments the cached plan's fields; only y
    (and on the persistent path the partials) allocated; the path's
    counter moves with ``launches``; ``persistent=True`` takes that path."""
    calls = []

    def fake_launch(name, fn, argtypes, device, *args):
        assert fn == "instance_norm_act_launch" and len(args) == len(argtypes)
        calls.append(args)

    monkeypatch.setattr(k7, "check_device", lambda *a: False)
    monkeypatch.setattr(k7, "launch", fake_launch)
    monkeypatch.setattr(k7, "sm_count", lambda device: SMS)
    x = torch.zeros((2, 13, 37, 64))
    with torch.no_grad():
        for persistent in (False, True):
            p = _plan(x.shape, torch.float32, persistent)
            before = (k7.instance_norm_act.launches, k7.instance_norm_act.cluster_launches,
                      k7.instance_norm_act.persistent_launches)
            y = k7.instance_norm_act(x, None, "relu", persistent=persistent)
            assert y.shape == x.shape and y.dtype == x.dtype
            args = calls[-1]
            assert args[3] is None and args[1] is None  # no statistics buffer, no residual
            assert (args[4] is None) == (p.path == "cluster")
            assert args[5:11] == (2, 13 * 37, 64, 0, 1, 1e-5)
            assert args[11:] == (k7._PATH_CODE[p.path], p.grid, p.ranges, p.gb, p.block_px,
                                 p.layers, p.smem)
            moved = (k7.instance_norm_act.launches - before[0],
                     k7.instance_norm_act.cluster_launches - before[1],
                     k7.instance_norm_act.persistent_launches - before[2])
            assert moved == ((1, 1, 0) if p.path == "cluster" else (1, 0, 1))
    assert [a[11] for a in calls] == [0, 1]
    hits = k7.norm_plan.cache_info().hits
    k7.plan_for(x)
    assert k7.norm_plan.cache_info().hits == hits + 1
