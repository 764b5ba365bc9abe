"""The backward of the spatially sharded generator in the port, on the CPU:

* K2's halo W mode: ``conv3x3_fused_t(w_mode='halo')`` under autograd
  against ``jax.grad`` of the JAX ``conv3x3_fused_t(embed_halo_w(hp),
  w_mode='halo')`` (Pallas interpret mode), from the same exchanged input
  ``hp`` (N, H, W+2, C) with wrap or zero-edge halo columns, with and
  without the prologue, cotangents on the output and on both moments. The
  JAX input is the scratch layout, so its cotangent is taken with respect
  to ``hp`` through the embedding, and dx is compared on all W+2 columns
  (the halo columns' cotangents included). Bound: |d| <= tol (1 + |ref|),
  tol f32 1e-4, bf16 2e-2 (the forward's bounds, tighter here than the
  gradient bounds of tests/unit/test_fused_train.py).
* The adjoints of ``HaloCtx``'s differentiable collectives, on 2 and 4
  spawned gloo ranks: the ring (``pad_w``, periodic and zero-edge, several
  halo widths), the sum over the ranks (``sum_w``) and ``all_gather_w``.
  Every rank's loss is its output times a cotangent of its own; the
  shards' input gradients must equal the whole field's autograd of the
  sum of those losses (f32, 1e-6).
* A port of tests/distributed/test_fused_spatial.py:82: resnet_3blocks
  (ngf 8) sharded on the same ranks, fused (the halo W mode, wrap and
  zero-edge) and unfused, in train mode; the gradients of sum(G(x) * gy),
  summed over the ranks, and of the input must equal the unfused
  whole-field autograd (rtol 2e-4, atol 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.ops.pallas_conv import conv3x3_fused_t as jax_fused_t
from biasgan_tpu.ops.pallas_conv import embed_halo_w, fused_block_plan
from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused
from biasgan_tpu_torch.nn import define_G
from biasgan_tpu_torch.ops.padding import pad_axis
from biasgan_tpu_torch.parallel import spawn
from biasgan_tpu_torch.parallel.checks import grad_checks

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
SPAWN_TIMEOUT_S = 300


def _t(a, grad=True):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _halo_data(seed, edge, h=10, w=16, c=8, co=8, n=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    if edge == "wrap":
        hp = np.concatenate([x[:, :, -1:], x, x[:, :, :1]], axis=2)
    else:
        z = np.zeros((n, h, 1, c), np.float32)
        hp = np.concatenate([z, x, z], axis=2)
    return dict(
        hp=hp, k=(rng.randn(3, 3, c, co) * 0.1).astype(np.float32),
        bias=(rng.randn(co) * 0.1).astype(np.float32),
        a=(1 + 0.1 * rng.randn(n, c)).astype(np.float32),
        b=(0.1 * rng.randn(n, c)).astype(np.float32),
        gy=rng.randn(n, h, w, co).astype(np.float32),
        gs=rng.randn(n, co).astype(np.float32),
        gq=(0.1 * rng.randn(n, co)).astype(np.float32),
    )


def _jax_halo_grads(d, prologue, h_mode, dtype):
    n, h, wp, c = d["hp"].shape
    plan = fused_block_plan(h, wp - 2, c, d["k"].shape[3], dtype, interpret=True)

    def loss(hp, k, bias, a, b):
        x = embed_halo_w(hp.astype(dtype))
        x = jnp.pad(x, ((0, 0), (0, plan.h_run - h), (0, 0), (0, 0)))
        y, (s, q) = jax_fused_t(x, k.astype(dtype), bias, prologue=(a, b) if prologue else None,
                                plan=plan, h_mode=h_mode, w_mode="halo")
        return (jnp.sum(y[:, :h].astype(jnp.float32) * d["gy"]) + jnp.sum(s * d["gs"])
                + jnp.sum(q * d["gq"]))

    argnums = (0, 1, 2, 3, 4) if prologue else (0, 1, 2)
    return jax.value_and_grad(loss, argnums=argnums)(
        d["hp"], d["k"], d["bias"], d["a"], d["b"])


def _port_halo_grads(d, prologue, h_mode, dtype):
    thp, tk, tb, ta, tpb = (_t(d[k]) for k in ("hp", "k", "bias", "a", "b"))
    k_oihw = tk.permute(3, 2, 0, 1)
    y, (s, q) = conv3x3_fused(thp.to(dtype), k_oihw.to(dtype), tb,
                              (ta, tpb) if prologue else None, "relu", h_mode, "halo")
    assert y.grad_fn is not None and y.shape[2] == d["hp"].shape[2] - 2
    loss = ((y.float() * _t(d["gy"], False)).sum() + (s * _t(d["gs"], False)).sum()
            + (q * _t(d["gq"], False)).sum())
    loss.backward()
    grads = [thp.grad, tk.grad, tb.grad] + ([ta.grad, tpb.grad] if prologue else [])
    return float(loss.detach()), grads


@pytest.mark.parametrize("h_mode", ["reflect", "zero"])
@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("edge", ["wrap", "zero"])
def test_fused_t_halo_grads_match_jax(edge, prologue, h_mode):
    d = _halo_data(3 + prologue, edge)
    jv, jg = _jax_halo_grads(d, prologue, h_mode, jnp.float32)
    tv, tg = _port_halo_grads(d, prologue, h_mode, torch.float32)
    np.testing.assert_allclose(tv, float(jv), rtol=2e-5, atol=1e-4)
    for name, gt, gj in zip(("dhp", "dk", "dbias", "da", "db"), tg, jg):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL[torch.float32],
                                   err_msg=name)
    # the halo columns carry cotangent back to the neighbours
    assert np.abs(tg[0].numpy()[:, :, [0, -1]]).max() > 1e-3


@pytest.mark.parametrize("edge,prologue", [("wrap", True), ("zero", False)])
def test_fused_t_halo_grads_bf16_match_jax(edge, prologue):
    """bf16 compute: the backward's convs in bf16, as the JAX backward's
    preferred_element_type=cdt."""
    d = _halo_data(11, edge)
    _, jg = _jax_halo_grads(d, prologue, "reflect", jnp.bfloat16)
    _, tg = _port_halo_grads(d, prologue, "reflect", torch.bfloat16)
    for name, gt, gj in zip(("dhp", "dk", "dbias", "da", "db"), tg, jg):
        np.testing.assert_allclose(gt.float().numpy(), np.asarray(gj, np.float32),
                                   **TOL[torch.bfloat16], err_msg=name)


# ---------------------------------------------------------------------------
# over spawned ranks: the collectives' adjoints and the sharded generator
# ---------------------------------------------------------------------------

SHAPE = (2, 5, 24, 3)  # N, H, W (8 or 6 per shard), C
RINGS = [("ring", 1, 1, True), ("ring", 3, 3, True), ("ring", 2, 0, True),
         ("ring", 1, 1, False), ("ring", 2, 3, False)]
ADJOINTS = RINGS + [("sum",), ("gather",)]
SPEC = dict(netG="resnet_3blocks", input_nc=1, output_nc=1, ngf=8, norm="instance",
            out_activation="tanh")
HW = 64  # the block-level local width: 8 on 2 ranks, 4 on 4
GEN_CASES = [dict(w_mode="wrap", fused=True), dict(w_mode="zero", fused=True),
             dict(w_mode="wrap", fused=False)]


def _x():
    return np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)


def _cots(n):
    """Each rank's cotangent of each case's output, rank-major."""
    rng = np.random.default_rng(n)
    nn, h, w, c = SHAPE
    wl = w // n
    widths = {case: wl + case[1] + case[2] for case in RINGS}
    widths.update({("sum",): wl, ("gather",): w})
    return {case: rng.normal(size=(n, nn, h, wd, c)).astype(np.float32)
            for case, wd in widths.items()}


def _gen_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, HW, HW, 1)).astype(np.float32)
    gy = rng.normal(size=(2, HW, HW, 1)).astype(np.float32)
    G = define_G(**SPEC, w_mode="wrap", generator=torch.Generator().manual_seed(0))
    return {k: v.numpy().copy() for k, v in G.state_dict().items()}, x, gy


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sharded(request):
    n = request.param
    state, x, gy = _gen_inputs()
    adj, gen = spawn(grad_checks, n, ((_x(), _cots(n), ADJOINTS),
                                      (SPEC, state, x, gy, GEN_CASES)),
                     timeout=SPAWN_TIMEOUT_S, group_timeout=SPAWN_TIMEOUT_S)
    return n, adj, gen


def _whole_adjoint(n, case):
    """d/dx of the sum over the ranks of (rank r's output * its cotangent),
    by autograd on the whole field."""
    x = torch.from_numpy(_x()).requires_grad_(True)
    c = torch.from_numpy(_cots(n)[case])
    wl = SHAPE[2] // n
    if case[0] == "ring":
        _, left, right, periodic = case
        xp = pad_axis(x, 2, left, right, "wrap" if periodic else "zero")
        outs = [xp[:, :, r * wl:(r + 1) * wl + left + right] for r in range(n)]
    elif case[0] == "sum":
        total = sum(x[:, :, r * wl:(r + 1) * wl] for r in range(n))
        outs = [total] * n
    else:
        outs = [x] * n
    sum((o * c[r]).sum() for r, o in enumerate(outs)).backward()
    return x.grad.numpy()


@pytest.mark.parametrize("case", ADJOINTS, ids=lambda c: "_".join(map(str, c)))
def test_halo_ctx_adjoint_matches_whole_field(sharded, case):
    n, adj, _ = sharded
    got = adj[case]
    assert got.shape == SHAPE
    np.testing.assert_allclose(got, _whole_adjoint(n, case), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", range(len(GEN_CASES)))
def test_sharded_generator_grads_match_whole_field(sharded, case):
    """The port of test_fused_spatial.py:82: sharded (fused: the halo W
    mode) grads against the unfused whole field's."""
    n, _, gen = sharded
    c = GEN_CASES[case]
    state, x, gy = _gen_inputs()
    G = define_G(**SPEC, w_mode=c["w_mode"])
    G.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    G.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (G(xt) * torch.from_numpy(gy)).sum()
    loss.backward()
    got = gen["cases"][case]
    np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=1e-4, atol=1e-4)
    for name, p in G.named_parameters():
        np.testing.assert_allclose(got["grads"][name], p.grad.numpy(), rtol=2e-4, atol=5e-4,
                                   err_msg=name)
    np.testing.assert_allclose(got["dx"], xt.grad.numpy(), rtol=2e-4, atol=5e-4)


def test_sharded_grads_launch_no_kernel_on_the_cpu(sharded):
    n, _, gen = sharded
    assert len(gen["launches"]) == n
    assert all(v == 0 for counts in gen["launches"] for v in counts.values())
