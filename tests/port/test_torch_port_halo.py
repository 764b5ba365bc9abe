"""The halo exchange of the port (biasgan_tpu_torch/kernels/halo_exchange.py)
and the halo W mode of its fused block conv (kernels/conv3x3_fused.py),
against the JAX package.

* The ring: four spawned gloo ranks (one spawn carries every case) pad
  their W shard through ``HaloCtx.pad_w`` with both transports, the plain
  ``batch_isend_irecv`` ring and the ``halo_exchange_w`` wrapper (on the
  CPU its plain version); the padded shards must equal, bitwise, those of
  the JAX ``halo_exchange_w(..., interpret=True)`` under ``shard_map`` on
  four devices of the conftest's virtual mesh, for the cases of
  tests/distributed/test_pallas_halo.py, and a halo wider than the shard
  raises as there.
* The halo W mode: ``conv3x3_fused(w_mode='halo')`` (on the CPU its plain
  version) against the Pallas ``conv3x3_fused(embed_halo_w(xp),
  w_mode='halo')`` in interpret mode: y to 1e-4 (f32) / 2e-2 (bf16), the
  moments to 1e-4 (f32) or 1e-3 relative (bf16), and in both no further
  from the reference's than the stored outputs are (moments of the stored
  value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from biasgan_tpu.ops.pallas_conv import FusedBlockPlan, embed_halo_w
from biasgan_tpu.ops.pallas_conv import conv3x3_fused as jax_conv3x3_fused
from biasgan_tpu.ops.pallas_halo import halo_exchange_w as jax_halo_exchange_w
from biasgan_tpu.parallel import make_mesh
from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused, conv3x3_fused_t
from biasgan_tpu_torch.kernels.halo_exchange import HaloRing, halo_exchange_w
from biasgan_tpu_torch.parallel import spawn
from biasgan_tpu_torch.parallel.checks import halo_cases

N_SHARDS = 4
CASES = [(l, r, p) for p in (True, False) for l, r in ((1, 1), (2, 3), (3, 0), (0, 2))]
SPAWN_TIMEOUT_S = 240


def _x():
    return np.random.default_rng(0).normal(size=(2, 6, 8 * N_SHARDS, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def ring_results():
    return spawn(halo_cases, N_SHARDS, (_x(), CASES), timeout=SPAWN_TIMEOUT_S,
                 group_timeout=SPAWN_TIMEOUT_S)


def _jax_rdma(left, right, periodic):
    mesh = make_mesh(data=1, spatial=N_SHARDS)

    def via_rdma(xl):
        lh, rh = jax_halo_exchange_w(xl, left, right, "spatial", periodic, interpret=True)
        parts = ([lh] if left else []) + [xl] + ([rh] if right else [])
        return jnp.concatenate(parts, axis=2)

    spec = P(None, None, "spatial", None)
    f = shard_map(via_rdma, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(_x())))


@pytest.mark.parametrize("rdma", [False, True], ids=["ring", "rdma"])
@pytest.mark.parametrize("left,right,periodic", CASES)
def test_ring_matches_jax_halo_exchange(ring_results, left, right, periodic, rdma):
    got = ring_results[(left, right, periodic, rdma)]
    want = _jax_rdma(left, right, periodic)
    assert got.shape == want.shape == (2, 6, N_SHARDS * (8 + left + right), 3)
    np.testing.assert_array_equal(got, want)


def test_halo_wider_than_shard_rejected(ring_results):
    assert "wider than local shard width 8" in ring_results["guard"]
    with pytest.raises(ValueError, match="wider than local shard"):
        mesh = make_mesh(data=1, spatial=N_SHARDS)
        spec = P(None, None, "spatial", None)
        f = shard_map(
            lambda xl: jax_halo_exchange_w(xl, 9, 0, "spatial", True, interpret=True)[0],
            mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False,
        )
        jax.jit(f)(jnp.asarray(_x()))


@pytest.mark.parametrize("periodic", [True, False])
def test_self_ring_on_the_cpu_launches_no_kernel(periodic):
    """One shard, no process group: the wrapper takes its plain version on
    a CPU tensor, a wrap (periodic) or a zero pad."""
    x = torch.from_numpy(_x())
    before = halo_exchange_w.launches
    lh, rh = halo_exchange_w(x, 2, 1, HaloRing(1, periodic))
    assert halo_exchange_w.launches == before
    want = np.pad(_x(), ((0, 0), (0, 0), (2, 1), (0, 0)), mode="wrap" if periodic else "constant")
    np.testing.assert_array_equal(torch.cat([lh, x, rh], dim=2).numpy(), want)
    with pytest.raises(RuntimeError, match="needs torch.distributed"):
        HaloRing(2)


# ---------------------------------------------------------------------------
# conv3x3_fused, w_mode='halo'
# ---------------------------------------------------------------------------

N, H, W, C = 2, 13, 16, 8  # the Pallas halo mode takes W % 8 == 0
TH = 4


def _conv_data(seed, prologue):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(N, H, W + 2, C)).astype(np.float32)  # with its halo columns
    k = (rng.normal(size=(3, 3, C, C)) * 0.2).astype(np.float32)  # HWIO
    b = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    pro = None
    if prologue:
        pro = ((rng.random((N, C)) + 0.5).astype(np.float32),
               (rng.normal(size=(N, C)) * 0.5).astype(np.float32))
    return xp, k, b, pro


def _jax_halo(xp, k, b, pro, dtype, h_mode):
    plan = FusedBlockPlan(H, TH, 16, True)
    xj = embed_halo_w(jnp.asarray(xp).astype(dtype))
    tail = jnp.full((N, plan.h_run - H, xj.shape[2], C), 7.75, xj.dtype)  # never read
    y, (s, q) = jax_conv3x3_fused(
        jnp.concatenate([xj, tail], axis=1), jnp.asarray(k).astype(dtype), jnp.asarray(b),
        prologue=None if pro is None else tuple(map(jnp.asarray, pro)), act_pre="relu",
        plan=plan, h_mode=h_mode, w_mode="halo", want_moments=True,
    )
    return np.asarray(y[:, :H], np.float32), np.asarray(s), np.asarray(q)


def _port_halo(xp, k, b, pro, dtype, h_mode):
    td = getattr(torch, dtype)
    y, (s, q) = conv3x3_fused(
        torch.from_numpy(xp).to(td), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(td),
        torch.from_numpy(b), prologue=None if pro is None else tuple(map(torch.from_numpy, pro)),
        act_pre="relu", h_mode=h_mode, w_mode="halo", want_moments=True,
    )
    assert y.dtype == td and tuple(y.shape) == (N, H, W, C)
    return y.float().numpy(), s.numpy(), q.numpy()


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("h_mode", ["reflect", "zero"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_mode_matches_pallas_interpret(dtype, h_mode, prologue):
    args = _conv_data(7 + prologue, prologue)
    (y, s, q) = _port_halo(*args, dtype, h_mode)
    (ry, rs, rq) = _jax_halo(*args, getattr(jnp, dtype), h_mode)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y, ry, rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(s, rs, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(q, rq, rtol=1e-4, atol=1e-4)
    else:
        assert np.all(np.abs(s - rs) <= 1e-3 * np.sqrt(H * W * rq))
        assert np.all(np.abs(q - rq) <= 1e-3 * rq)
    slack = 1e-5  # f32 summation order
    dsum = np.abs(y - ry).sum(axis=(1, 2)) + slack * np.abs(ry).sum(axis=(1, 2))
    dsq = np.abs(y**2 - ry**2).sum(axis=(1, 2)) + slack * (ry**2).sum(axis=(1, 2))
    assert np.all(np.abs(s - rs) <= dsum), np.abs(s - rs) / dsum
    assert np.all(np.abs(q - rq) <= dsq), np.abs(q - rq) / dsq


def test_halo_mode_equals_inkernel_wrap():
    """Halo columns that are the wrap columns give the in-kernel wrap pad,
    prologue included (the single-shard identity the sharded path rests
    on)."""
    xp, k, b, pro = _conv_data(3, True)
    x = torch.from_numpy(xp[:, :, 1:-1].copy())
    halo = torch.cat([x[:, :, -1:], x, x[:, :, :1]], dim=2)
    kt, bt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b)
    pro = tuple(map(torch.from_numpy, pro))
    y, m = conv3x3_fused(halo, kt, bt, prologue=pro, w_mode="halo")
    ry, rm = conv3x3_fused(x, kt, bt, prologue=pro, w_mode="wrap")
    np.testing.assert_allclose(y.numpy(), ry.numpy(), rtol=1e-6, atol=1e-6)
    for a, r in zip(m, rm):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-6, atol=1e-5)


def test_halo_mode_checks_and_refuses_training():
    """'halo' is a W mode only. The halo mode trains (the block conv's
    backward covers the halo columns), but the halo kernel does not: it
    has no backward, and neither it nor ``HaloCtx.pad_w`` with ``rdma``
    runs where autograd records."""
    from biasgan_tpu_torch.parallel import HaloCtx

    xp, k, b, _ = _conv_data(0, False)
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    with pytest.raises(ValueError, match="unknown h_mode 'halo'"):
        conv3x3_fused(torch.from_numpy(xp), kt, h_mode="halo")
    xg = torch.from_numpy(xp).requires_grad_(True)
    y, _ = conv3x3_fused_t(xg, kt, w_mode="halo")
    assert y.grad_fn is not None and y.shape[2] == xp.shape[2] - 2
    with pytest.raises(RuntimeError, match="no backward"):
        halo_exchange_w(xg, 1, 1, HaloRing(1))
    with pytest.raises(RuntimeError, match="no backward"):
        HaloCtx(1, rdma=True).pad_w(xg, 1, 1)
