"""The differentiable kernels of the PyTorch port against the JAX custom
VJPs, on the CPU (the JAX Pallas kernels in interpret mode):

* ``conv3x3_fused_t`` (K2) against ``jax.grad`` of the JAX
  ``conv3x3_fused_t`` over the cases of tests/unit/test_fused_train.py
  (less the ``halo`` W mode), with cotangents on the output and on both
  moments; and in bf16;
* ``conv7x7`` (K3) and ``instance_norm_act`` (K7) under autograd against
  ``conv7x7_op`` and ``fused_instance_norm_act``;
* the resnet generator's parameter and input gradients under
  ``fused_blocks`` and under ``pallas_conv`` against the JAX generator's
  with the same routes open (test_fused_train.py:169-200: 2e-4 / 5e-4);
* the rule that no wrapper returns a result without a grad_fn where
  autograd records: a faked device sends the dispatch down the kernel
  branch with a fake launcher.

Tolerances: f32 2e-5 relative / 2e-4 absolute, the JAX tests' bounds;
bf16 0.05 max(1, |ref|) absolute / 0.1 relative (test_fused_train.py:
130-136)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.nn.generators import ResNetGenerator
from biasgan_tpu.ops.pallas_conv import conv3x3_fused_t as jax_fused_t
from biasgan_tpu.ops.pallas_conv import fused_block_plan
from biasgan_tpu.ops.pallas_conv7 import conv7x7_op
from biasgan_tpu.ops.pallas_fused import fused_instance_norm_act
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.kernels import conv3x3_fused as k1
from biasgan_tpu_torch.kernels import conv3x3s2_fused as k4
from biasgan_tpu_torch.kernels import conv3x3_valid as k6
from biasgan_tpu_torch.kernels import conv7x7 as k3
from biasgan_tpu_torch.kernels import convt3x3s2_fused as k5
from biasgan_tpu_torch.kernels import instance_norm_act as k7
from biasgan_tpu_torch.nn import define_G

F32 = dict(rtol=2e-5, atol=2e-4)


def _t(a, grad=True):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize(
    "h_mode,w_mode,lh,prologue",
    [("reflect", "wrap", 13, True), ("reflect", "reflect", 10, True),
     ("wrap", "zero", 12, False), ("zero", "wrap", 11, True)],
)
def test_fused_t_grads_match_jax(h_mode, w_mode, lh, prologue):
    n, w, c, co = 2, 16, 8, 8
    rng = np.random.RandomState(lh)
    plan = fused_block_plan(lh, w, c, co, jnp.float32, interpret=True)
    x = rng.randn(n, lh, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, co) * 0.1).astype(np.float32)
    bias = (rng.randn(co) * 0.1).astype(np.float32)
    a = (1 + 0.1 * rng.randn(n, c)).astype(np.float32)
    b = (0.1 * rng.randn(n, c)).astype(np.float32)
    gy = rng.randn(n, lh, w, co).astype(np.float32)
    gs = rng.randn(n, co).astype(np.float32)
    gq = (0.1 * rng.randn(n, co)).astype(np.float32)

    def jloss(x, k, bias, a, b):
        xr = jnp.pad(x, ((0, 0), (0, plan.h_run - lh), (0, 0), (0, 0)))
        y, (s, q) = jax_fused_t(xr, k, bias, prologue=(a, b) if prologue else None,
                                plan=plan, h_mode=h_mode, w_mode=w_mode)
        return jnp.sum(y[:, :lh] * gy) + jnp.sum(s * gs) + jnp.sum(q * gq)

    argnums = (0, 1, 2, 3, 4) if prologue else (0, 1, 2)
    jv, jg = jax.value_and_grad(jloss, argnums=argnums)(x, k, bias, a, b)
    tx, tk, tb = _t(x), _t(k.transpose(3, 2, 0, 1)), _t(bias)
    ta, tpb = _t(a), _t(b)
    y, (s, q) = k1.conv3x3_fused(tx, tk, tb, (ta, tpb) if prologue else None,
                                 "relu", h_mode, w_mode)
    assert y.grad_fn is not None  # through conv3x3_fused_t
    tv = (y * _t(gy, False)).sum() + (s * _t(gs, False)).sum() + (q * _t(gq, False)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=2e-5, atol=1e-4)
    got = [tx.grad, tk.grad.permute(2, 3, 1, 0), tb.grad] + ([ta.grad, tpb.grad] if prologue else [])
    for name, gt, gj in zip(("dx", "dk", "dbias", "da", "db"), got, jg):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **F32, err_msg=name)


def test_fused_t_grads_bf16_match_jax():
    """bf16 compute: the backward's convs in bf16, as the JAX backward's
    preferred_element_type=cdt."""
    n, lh, w, c = 2, 8, 16, 8
    rng = np.random.RandomState(7)
    plan = fused_block_plan(lh, w, c, c, jnp.bfloat16, interpret=True)
    x = rng.randn(n, lh, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    a = (1 + 0.1 * rng.randn(n, c)).astype(np.float32)
    b = (0.1 * rng.randn(n, c)).astype(np.float32)
    gy = rng.randn(n, lh, w, c).astype(np.float32)

    def jloss(x, k, bias, a, b):
        xr = jnp.pad(x.astype(jnp.bfloat16), ((0, 0), (0, plan.h_run - lh), (0, 0), (0, 0)))
        y, (s, q) = jax_fused_t(xr, k.astype(jnp.bfloat16), bias, prologue=(a, b),
                                plan=plan, h_mode="reflect", w_mode="wrap")
        return jnp.sum(y[:, :lh].astype(jnp.float32) * gy) + jnp.sum(s) + 0.1 * jnp.sum(q)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(x, k, bias, a, b)
    tx, tk, tb, ta, tpb = _t(x), _t(k.transpose(3, 2, 0, 1)), _t(bias), _t(a), _t(b)
    y, (s, q) = k1.conv3x3_fused_t(tx.to(torch.bfloat16), tk.to(torch.bfloat16), tb, (ta, tpb))
    ((y.float() * _t(gy, False)).sum() + s.sum() + 0.1 * q.sum()).backward()
    got = [tx.grad, tk.grad.permute(2, 3, 1, 0), tb.grad, ta.grad, tpb.grad]
    for name, gt, gj in zip(("dx", "dk", "dbias", "da", "db"), got, jg):
        gj = np.asarray(gj, np.float32)
        np.testing.assert_allclose(gt.float().numpy(), gj, rtol=0.1,
                                   atol=0.05 * max(1.0, np.abs(gj).max()), err_msg=name)


@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 3)])
def test_conv7x7_grads_match_jax(cin, cout):
    rng = np.random.RandomState(cin)
    xp = rng.randn(2, 14, 14, cin).astype(np.float32)
    k = (rng.randn(7, 7, cin, cout) * 0.05).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    g = rng.randn(2, 8, 8, cout).astype(np.float32)
    jg = jax.grad(lambda xp, k, b: jnp.sum(conv7x7_op(xp, k, b, True) * g),
                  argnums=(0, 1, 2))(jnp.asarray(xp), jnp.asarray(k), jnp.asarray(bias))
    txp, tk, tb = _t(xp), _t(k.transpose(3, 2, 0, 1)), _t(bias)
    y = k3.conv7x7(txp, tk, tb)
    assert y.grad_fn is not None
    (y * _t(g, False)).sum().backward()
    for gt, gj in zip((txp.grad, tk.grad.permute(2, 3, 1, 0), tb.grad), jg):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **F32)


@pytest.mark.parametrize("act,res", [("relu", False), ("lrelu", True), ("none", True)])
def test_instance_norm_act_grads_match_jax(act, res):
    rng = np.random.RandomState(len(act))
    x = (rng.randn(2, 6, 10, 8) * 2 + 0.5).astype(np.float32)
    r = rng.randn(2, 6, 10, 8).astype(np.float32)
    g = rng.randn(2, 6, 10, 8).astype(np.float32)

    def jloss(x, r):
        return jnp.sum(fused_instance_norm_act(x, r if res else None, act, 1e-5, True, True) * g)

    jg = jax.grad(jloss, argnums=(0, 1))(x, r)
    tx, tr = _t(x), _t(r)
    y = k7.instance_norm_act(tx, tr if res else None, act)
    assert y.grad_fn is not None
    (y * _t(g, False)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), **F32)
    if res:
        np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jg[1]), **F32)


def _tree_close(got, want, **tol):
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert sorted(map(str, flat_w)) == sorted(map(str, flat_g))
    for path, wv in flat_w.items():
        np.testing.assert_allclose(np.asarray(flat_g[path]), np.asarray(wv), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _port_grads(G):
    return state_dict_to_params({n: p.grad for n, p in G.named_parameters()})[0]


@pytest.mark.parametrize("route", ["fused_blocks", "pallas_conv"])
def test_generator_grads_match_jax(route, monkeypatch):
    """The generator's training gradients through each kernel route against
    the JAX generator's with the same route open: the fused block path
    (the h_run tail forced through TH=2, as the JAX test) and the Pallas
    VALID conv (ngf 32: the JAX route takes convs of >= 128 channels)."""
    ngf, x_shape = (8, (1, 20, 32, 3)) if route == "fused_blocks" else (32, (1, 16, 32, 3))
    g = ResNetGenerator(output_nc=3, ngf=ngf, n_blocks=2, norm_type="instance",
                        use_dropout=False, w_mode="wrap")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), x_shape))
    gy = np.asarray(jax.random.normal(jax.random.PRNGKey(1), x_shape))
    params = g.init(jax.random.PRNGKey(2), x)
    if route == "fused_blocks":
        env = {"BIASGAN_FUSED_BLOCK": "interpret", "BIASGAN_FUSED_TRAIN": "1",
               "BIASGAN_FUSED_MIN_C": "1", "BIASGAN_FUSED_TH": "2"}
    else:
        env = {"BIASGAN_PALLAS_CONV": "interpret"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(
        lambda p, x: jnp.sum(g.apply(p, x, train=True) * gy), argnums=(0, 1)))(params, x)

    G = define_G("resnet_2blocks", 3, 3, ngf=ngf, norm="instance", w_mode="wrap",
                 **{route: True})
    G.load_state_dict(params_to_state_dict(params["params"]))
    G.train()
    tx = _t(x)
    fn = k1._FusedT if route == "fused_blocks" else k6._Conv3x3Op
    calls = []
    real_apply = fn.apply
    monkeypatch.setattr(fn, "apply", lambda *a: calls.append(1) or real_apply(*a))
    tv = (G(tx) * _t(gy, False)).sum()
    tv.backward()
    assert len(calls) == 4  # 2 blocks x 2 convs
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=2e-4, atol=5e-4)
    _tree_close(_port_grads(G), jgp["params"], rtol=2e-4, atol=5e-4)


def test_wrappers_never_return_detached_results(monkeypatch):
    """The dispatch rule, on the kernel branch (the device check faked, a
    fake launcher in place of ctypes): where autograd records, K1, K3 and
    K7 return a result with a grad_fn, and the inference-only K4 and K5
    raise; under no_grad each launches."""
    launched = []

    def fake(name, shape_fn):
        def launch(*a, **kw):
            launched.append(name)
            return shape_fn(*a)
        return launch

    for mod, name, shape_fn in (
        (k1, "k1", lambda x, w, *r: (torch.zeros(x.shape[:3] + (w.shape[0],)),
                                     (torch.zeros(x.shape[0], w.shape[0]),
                                      torch.zeros(x.shape[0], w.shape[0])))),
        (k3, "k3", lambda xp, w, b: torch.zeros((xp.shape[0], xp.shape[1] - 6,
                                                 xp.shape[2] - 6, w.shape[0]))),
        (k7, "k7", lambda x, *r: torch.zeros_like(x)),
        (k4, "k4", lambda x, *r: None),
        (k5, "k5", lambda x, *r: None),
    ):
        monkeypatch.setattr(mod, "check_device", lambda *a: False)
        monkeypatch.setattr(mod, "_launch", fake(name, shape_fn))
    x = torch.randn(1, 8, 8, 4, requires_grad=True)
    w = torch.randn(4, 4, 3, 3)
    y, (s, q) = k1.conv3x3_fused(x, w)
    assert y.grad_fn is not None and s.grad_fn is not None
    assert k3.conv7x7(torch.randn(1, 14, 14, 3, requires_grad=True),
                      torch.randn(8, 3, 7, 7)).grad_fn is not None
    assert k7.instance_norm_act(x).grad_fn is not None
    for fn in (k4.conv3x3s2_fused, k5.convt3x3s2_fused):
        with pytest.raises(RuntimeError, match="inference-only"):
            fn(x, w)
    with torch.no_grad():
        k4.conv3x3s2_fused(x, w)
        k5.convt3x3s2_fused(x, w)
    assert launched == ["k1", "k3", "k7", "k4", "k5"]
