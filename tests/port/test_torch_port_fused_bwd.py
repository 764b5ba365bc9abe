"""The backward of K2 in the port, on the CPU: ``conv3x3_fused_bwd`` (the
CUDA kernel's plain version ``conv3x3_fused_bwd_plain``, which the CPU
takes) against ``jax.vjp`` of the JAX ``conv3x3_fused_t`` (the Pallas
forward in interpret mode, its XLA custom VJP ``_fused_diff_bwd``), from the
same numpy inputs and cotangents:

* every H pad mode with every W mode (wrap, reflect, zero, and the halo
  mode with periodic and zero-edge halo columns, through ``embed_halo_w``
  on the JAX side), each with the prologue under act relu, lrelu and none
  and without it, with and without the moments (their cotangents), with
  and without a bias; f32 at rtol 2e-5 / atol 2e-4 (test_fused_train.py's
  bounds), one bf16 case at rtol 0.1 / atol 0.05 max(1, |ref|);
* the dispatch on the kernel branch, with the device check and the ctypes
  launcher faked: ``_FusedT.backward`` on a "card" tensor launches the
  backward kernel once, never reaches ``aten.convolution_backward``, and
  the wrapper refuses a wrong dtype or shape.

The JAX kernel's plan needs W a multiple of 8 and H >= 3; the ragged and
tiny shapes (13 x 37, 9 x 5, H = 2) are held on the card, kernel against
this plain version (chip_smoke.py phase 3b, test_torch_port_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.ops.pallas_conv import conv3x3_fused_t as jax_fused_t
from biasgan_tpu.ops.pallas_conv import embed_halo_w, fused_block_plan
from biasgan_tpu_torch.kernels import conv3x3_fused as k1

F32 = dict(rtol=2e-5, atol=2e-4)
W_MODES = ["wrap", "reflect", "zero", "halo-wrap", "halo-zero"]
# (prologue, act, moments, bias): every act with the prologue, none without
VARIANTS = [(True, "relu", True, True), (True, "lrelu", False, True),
            (True, "none", True, False), (False, "relu", False, False)]


def _data(seed, w_mode, n=2, h=5, w=8, c=4, co=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    if w_mode == "halo-wrap":  # the columns a periodic ring brings
        x = np.concatenate([x[:, :, -1:], x, x[:, :, :1]], axis=2)
    elif w_mode == "halo-zero":  # a non-periodic global edge
        z = np.zeros((n, h, 1, c), np.float32)
        x = np.concatenate([z, x, z], axis=2)
    return dict(
        x=x, k=(rng.randn(3, 3, c, co) * 0.2).astype(np.float32),
        bias=(rng.randn(co) * 0.1).astype(np.float32),
        a=(1 + 0.2 * rng.randn(n, c)).astype(np.float32),
        b=(0.3 * rng.randn(n, c)).astype(np.float32),
        gy=rng.randn(n, h, w, co).astype(np.float32),
        gs=rng.randn(n, co).astype(np.float32),
        gq=(0.1 * rng.randn(n, co)).astype(np.float32),
    )


def _jax_vjp(d, h_mode, w_mode, pro, act, moments, bias, dtype):
    """jax.vjp of the JAX conv3x3_fused_t at the cotangents of ``d``: the
    gradients of x (all its columns in the halo mode), k, bias, a, b."""
    n, h, wx, c = d["x"].shape
    halo = w_mode == "halo"
    w = wx - 2 if halo else wx
    plan = fused_block_plan(h, w, c, d["k"].shape[3], dtype, interpret=True)

    def f(x, k, bias_, a, b):
        xe = embed_halo_w(x.astype(dtype)) if halo else x.astype(dtype)
        xe = jnp.pad(xe, ((0, 0), (0, plan.h_run - h), (0, 0), (0, 0)))
        out = jax_fused_t(xe, k.astype(dtype), bias_ if bias else None,
                          prologue=(a, b) if pro else None, act_pre=act, plan=plan,
                          h_mode=h_mode, w_mode=w_mode, want_moments=moments)
        y = (out[0] if moments else out)[:, :h].astype(jnp.float32)
        return (y, *out[1]) if moments else y

    _, pull = jax.vjp(f, d["x"], d["k"], d["bias"], d["a"], d["b"])
    return pull((d["gy"], d["gs"], d["gq"]) if moments else d["gy"])


def _port_bwd(d, h_mode, w_mode, pro, act, moments, bias, dtype):
    """The port's forward (for the stored y) and conv3x3_fused_bwd at the
    same cotangents, on the CPU: (dx, dk as HWIO, dbias, da, db)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
    x, wt = t["x"].to(dtype), t["k"].permute(3, 2, 0, 1).to(dtype)
    tb = t["bias"] if bias else None
    a, b = (t["a"], t["b"]) if pro else (None, None)
    y = k1.conv3x3_fused_plain(x, wt, tb, (a, b) if pro else None, act, h_mode, w_mode,
                               want_moments=False)
    ds, dq = (t["gs"], t["gq"]) if moments else (None, None)
    before = k1.conv3x3_fused_bwd.launches
    dx, dw, dbias, da, db = k1.conv3x3_fused_bwd(x, wt, tb, a, b, y, t["gy"].to(dtype), ds, dq,
                                                 act, h_mode, w_mode)
    assert k1.conv3x3_fused_bwd.launches == before  # the CPU takes the plain version
    assert dx.dtype == dtype and tuple(dx.shape) == tuple(x.shape)
    assert (dbias is None) == (not bias) and (da is None) == (db is None) == (not pro)
    return dx, dw.permute(2, 3, 1, 0), dbias, da, db


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "-".join(map(str, v)))
@pytest.mark.parametrize("w_mode", W_MODES)
@pytest.mark.parametrize("h_mode", ["reflect", "zero", "wrap"])
def test_fused_bwd_plain_matches_jax_vjp(h_mode, w_mode, variant):
    pro, act, moments, bias = variant
    d = _data(len(h_mode) + 7 * W_MODES.index(w_mode), w_mode)
    mode = "halo" if w_mode.startswith("halo") else w_mode
    ref = _jax_vjp(d, h_mode, mode, pro, act, moments, bias, jnp.float32)
    got = _port_bwd(d, h_mode, mode, pro, act, moments, bias, torch.float32)
    for name, g, r in zip(("dx", "dk", "dbias", "da", "db"), got, ref):
        if g is None:
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32, err_msg=name)


def test_fused_bwd_plain_bf16_matches_jax_vjp():
    """bf16 compute: the conv's VJP in bf16 on both sides, the pullback,
    dbias and the prologue chain in f32."""
    d = _data(11, "reflect")
    ref = _jax_vjp(d, "reflect", "reflect", True, "relu", True, True, jnp.bfloat16)
    got = _port_bwd(d, "reflect", "reflect", True, "relu", True, True, torch.bfloat16)
    for name, g, r in zip(("dx", "dk", "dbias", "da", "db"), got, ref):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0.1,
                                   atol=0.05 * max(1.0, np.abs(r).max()), err_msg=name)


def test_fused_bwd_kernel_branch_dispatch(monkeypatch):
    """With the device check faked to the kernel branch and ctypes faked:
    the backward of conv3x3_fused_t launches the backward kernel once (one
    C call, counted once), cuDNN's convolution_backward is never reached,
    and the wrapper refuses a mismatched dtype or shape."""
    calls = []

    def fake_launch(name, fn, argtypes, device, *args):
        assert len(args) == len(argtypes)
        calls.append(fn)

    def no_cudnn(*a, **kw):
        raise AssertionError("the kernel branch reached aten.convolution_backward")

    monkeypatch.setattr(k1, "check_device", lambda *a: False)
    monkeypatch.setattr(k1, "launch", fake_launch)
    monkeypatch.setattr(k1, "num_tiles", lambda *a: 64)  # tiles, workspace bytes
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", no_cudnn)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 6, 8, 4), generator=g, requires_grad=True)
    w = torch.randn((5, 4, 3, 3), generator=g, requires_grad=True)
    bias = torch.zeros(5, requires_grad=True)
    a = torch.ones((2, 4), requires_grad=True)
    b = torch.zeros((2, 4), requires_grad=True)
    before = k1.conv3x3_fused_bwd.launches
    y, (s, q) = k1.conv3x3_fused_t(x, w, bias, (a, b))
    (y.sum() + s.sum() + q.sum()).backward()
    assert calls == ["conv3x3_fused_launch", "conv3x3_fused_bwd_launch"]
    assert k1.conv3x3_fused_bwd.launches == before + 1
    for t in (x, w, bias, a, b):
        assert t.grad is not None and t.grad.shape == t.shape and t.grad.dtype == t.dtype

    with torch.no_grad():
        xd, wd = x.detach(), w.detach()
        yd, dyd = torch.zeros((2, 6, 8, 5)), torch.ones((2, 6, 8, 5))
        ds = torch.zeros((2, 5))
        with pytest.raises(TypeError, match="dy is torch.bfloat16"):
            k1.conv3x3_fused_bwd(xd, wd, None, None, None, yd, dyd.bfloat16(), None, None)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            k1.conv3x3_fused_bwd(xd.double(), wd, None, None, None, yd.double(),
                                 dyd.double(), None, None)
        with pytest.raises(ValueError, match="dy must be"):
            k1.conv3x3_fused_bwd(xd, wd, None, None, None, yd, dyd[:, :, 1:], None, None)
        with pytest.raises(ValueError, match="ds must be"):
            k1.conv3x3_fused_bwd(xd, wd, None, None, None, yd, dyd, ds[:, 1:], ds)
        with pytest.raises(ValueError, match="come together"):
            k1.conv3x3_fused_bwd(xd, wd, None, None, None, yd, dyd, ds, None)
        with pytest.raises(ValueError, match="y must be"):  # halo mode: y is W-2 wide
            k1.conv3x3_fused_bwd(xd, wd, None, None, None, yd, dyd, None, None,
                                 w_mode="halo")
    assert calls == ["conv3x3_fused_launch", "conv3x3_fused_bwd_launch"]
