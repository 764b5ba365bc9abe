"""The backward of K7 in the port, on the CPU: ``instance_norm_act_bwd``
(the CUDA kernel's plain version ``instance_norm_act_bwd_plain``, which the
CPU takes), fed by the plain statistics helper ``instance_norm_stats_plain``,
against ``jax.vjp`` of the JAX ``fused_instance_norm_act`` (the Pallas
forward in interpret mode, its XLA custom VJP ``_bwd``), from the same numpy
inputs and cotangents:

* every act (none, relu, lrelu) with and without a residual, at
  (2, 5, 7, 12) (C not a multiple of 8), (1, 1, 1, 8) (H W = 1: dx is 0)
  and (2, 6, 4, 16); f32 at rtol 2e-4 / atol 1e-5, one bf16 case within
  2e-2 of max(1, |ref|). The JAX ``_fwd`` recomputes the statistics from x;
  the port's come from the forward, which differs only by the order of the
  f32 sums;
* the statistics helper against the JAX ``_fwd``'s own 1/std and x-hat,
  and against ``torch.var_mean``;
* the dispatch on the kernel branch, with the device check and the ctypes
  launcher faked: a backward through ``instance_norm_act`` on a "card"
  tensor launches the forward and then the backward kernel once each,
  runs nothing of the torch-ops backward, passes no residual gradient
  buffer where the residual needs none, and the wrapper refuses a wrong
  dtype or shape.

The kernel itself is held to the plain version on the card
(test_torch_port_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.ops.pallas_fused import _fwd as jax_fwd
from biasgan_tpu.ops.pallas_fused import fused_instance_norm_act
from biasgan_tpu_torch.kernels import instance_norm_act as k7

SHAPES = [(2, 5, 7, 12), (1, 1, 1, 8), (2, 6, 4, 16)]
ACTS = ["none", "relu", "lrelu"]
F32 = dict(rtol=2e-4, atol=1e-5)


def _data(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, r, g


def _jax_vjp(x, r, g, act, res, dtype):
    """(dx, d_res or None) of the JAX op at cotangent ``g``."""
    jd = getattr(jnp, dtype)
    xs = [jnp.asarray(x).astype(jd)] + ([jnp.asarray(r).astype(jd)] if res else [])

    def fn(x, *r):
        return fused_instance_norm_act(x, r[0] if r else None, act, 1e-5, True, True)

    _, vjp = jax.vjp(fn, *xs)
    grads = vjp(jnp.asarray(g).astype(jd))
    return [np.asarray(t, np.float32) for t in grads] + ([None] if not res else [])


def _port_bwd(x, r, g, act, res, dtype):
    """(dx, d_res or None) of the port: the plain forward's output, the
    statistics helper, the backward's plain version."""
    td = getattr(torch, dtype)
    tx, tr, tg = (torch.from_numpy(a).to(td) for a in (x, r, g))
    out = k7.instance_norm_act_plain(tx, tr if res else None, act)
    stats = k7.instance_norm_stats_plain(tx)
    assert stats.dtype == torch.float32 and stats.shape == (2, x.shape[0], x.shape[3])
    dx, d_res = k7.instance_norm_act_bwd(tx, out, tg, stats, act, res)
    assert dx.dtype == td and (d_res is None) == (not res)
    return dx, d_res


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_norm_bwd_plain_matches_jax_vjp(shape, act, res):
    x, r, g = _data(sum(shape) + len(act) + res, shape)
    rdx, rd_res = _jax_vjp(x, r, g, act, res, "float32")
    dx, d_res = _port_bwd(x, r, g, act, res, "float32")
    np.testing.assert_allclose(dx.numpy(), rdx, **F32)
    if shape[1] * shape[2] == 1:
        assert not dx.any()
    if res:
        np.testing.assert_allclose(d_res.numpy(), rd_res, **F32)


def test_norm_bwd_plain_bf16_matches_jax_vjp():
    x, r, g = _data(3, (2, 6, 4, 16))
    for got, ref in zip(_port_bwd(x, r, g, "relu", True, "bfloat16"),
                        _jax_vjp(x, r, g, "relu", True, "bfloat16")):
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(got.float().numpy() - ref).max() <= 2e-2 * scale


@pytest.mark.parametrize("shape", SHAPES)
def test_stats_helper_matches_forward_stats(shape):
    """mean and 1/std of the helper against the JAX _fwd's saved 1/std and
    x-hat, and against torch.var_mean (biased) + eps."""
    x, _, _ = _data(len(shape) + shape[3], shape)
    mean, inv = k7.instance_norm_stats_plain(torch.from_numpy(x))
    _, (jxhat, jinv, _, _) = jax_fwd(jnp.asarray(x), None, "none", 1e-5, True, True)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv)[:, 0, 0], rtol=1e-5)
    xhat = (torch.from_numpy(x) - mean[:, None, None]) * inv[:, None, None]
    np.testing.assert_allclose(xhat.numpy(), np.asarray(jxhat), rtol=1e-5, atol=1e-5)
    var, tmean = torch.var_mean(torch.from_numpy(x).double(), dim=(1, 2), unbiased=False)
    np.testing.assert_allclose(mean.numpy(), tmean.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(inv.numpy(), (var + 1e-5).rsqrt().numpy(), rtol=1e-4)


def test_norm_bwd_kernel_branch_dispatch(monkeypatch):
    """With the device check faked to the kernel branch and ctypes faked:
    a backward through instance_norm_act issues the forward launch and one
    backward launch (one C call, counted once), nothing of the torch-ops
    backward runs, the residual's gradient buffer is passed only where the
    residual needs a gradient, and the wrapper refuses a mismatched dtype or
    shape."""
    calls = []

    def fake_launch(name, fn, argtypes, device, *args):
        assert len(args) == len(argtypes)
        calls.append((fn, args))

    def no_plain(*a, **kw):
        raise AssertionError("the kernel branch ran the torch-ops backward")

    monkeypatch.setattr(k7, "check_device", lambda *a: False)
    monkeypatch.setattr(k7, "launch", fake_launch)
    monkeypatch.setattr(k7, "num_tiles", lambda *a: 3)
    monkeypatch.setattr(k7, "sm_count", lambda device: 132)  # the forward's plan reads the card
    monkeypatch.setattr(k7, "instance_norm_act_bwd_plain", no_plain)
    monkeypatch.setattr(k7, "_act_grad_from_out", no_plain)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 7, 12), generator=g, requires_grad=True)
    for r_grad in (True, False):
        r = torch.randn((2, 5, 7, 12), generator=g, requires_grad=r_grad)
        calls.clear()
        before = k7.instance_norm_act_bwd.launches
        y = k7.instance_norm_act(x, r, "lrelu")
        y.backward(torch.ones_like(y))
        assert [fn for fn, _ in calls] == ["instance_norm_act_launch",
                                           "instance_norm_act_bwd_launch"]
        assert k7.instance_norm_act_bwd.launches == before + 1
        d_res_ptr = calls[1][1][5]
        assert (d_res_ptr is not None) == r_grad
        assert x.grad is not None and x.grad.shape == x.shape
        assert (r.grad is not None) == r_grad
        x.grad = None

    with torch.no_grad():
        xd = x.detach()
        stats = torch.zeros((2, 2, 12))
        with pytest.raises(TypeError, match="g is torch.bfloat16"):
            k7.instance_norm_act_bwd(xd, xd, xd.bfloat16(), stats)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            k7.instance_norm_act_bwd(xd.double(), xd.double(), xd.double(), stats)
        with pytest.raises(TypeError, match="stats must be float32"):
            k7.instance_norm_act_bwd(xd, xd, xd, stats.double())
        with pytest.raises(ValueError, match="g must be"):
            k7.instance_norm_act_bwd(xd, xd, xd[:, 1:], stats)
        with pytest.raises(ValueError, match="stats must be"):
            k7.instance_norm_act_bwd(xd, xd, xd, stats[:, :, 1:])
        with pytest.raises(ValueError, match="unknown activation"):
            k7.instance_norm_act_bwd(xd, xd, xd, stats, "tanh")
    assert len(calls) == 2
