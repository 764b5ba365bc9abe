"""conv3x3_fused of the PyTorch port (biasgan_tpu_torch/kernels/
conv3x3_fused.py) against the JAX Pallas kernel it replaces
(biasgan_tpu/ops/pallas_conv.py::conv3x3_fused), run as the JAX package's
own tests run it on the CPU: in interpret mode, with a sentinel-filled
h_run tail, sliced to the logical rows (tests/unit/test_fused_block.py).

On the CPU the port's wrapper takes its plain PyTorch version, so these
tests hold that version to the Pallas kernel. The CUDA kernel is held to
the plain version on the card (test_torch_port_cuda.py, chip_smoke.py).
Tolerances: f32 1e-4, bf16 2e-2 on y; moments 1e-4 (f32) or 1e-3
relative (bf16), and in both no further from the reference's than the
stored outputs are (the moments are those of the stored value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.ops.pallas_conv import FusedBlockPlan
from biasgan_tpu.ops.pallas_conv import conv3x3_fused as jax_conv3x3_fused
from biasgan_tpu_torch.kernels.conv3x3_fused import (
    apply_affine,
    conv3x3_fused,
    instance_moments_to_affine,
)

N, H, W, C = 2, 13, 16, 8
TH = 4  # Pallas row tile: 13 rows -> 4 tiles, the last one partial


def _data(dtype, seed=0, prologue=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    k = (rng.normal(size=(3, 3, C, C)) * 0.2).astype(np.float32)  # HWIO
    b = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    pro = None
    if prologue:
        pro = ((rng.random((N, C)) + 0.5).astype(np.float32),
               (rng.normal(size=(N, C)) * 0.5).astype(np.float32))
    return x, k, b, pro


def _jax(x, k, b, pro, dtype, h_mode, w_mode):
    plan = FusedBlockPlan(H, TH, 16, True)
    xj = jnp.asarray(x).astype(dtype)
    tail = jnp.full((N, plan.h_run - H, W, C), 7.75, xj.dtype)  # never read
    y, (s, q) = jax_conv3x3_fused(
        jnp.concatenate([xj, tail], axis=1), jnp.asarray(k).astype(dtype),
        jnp.asarray(b), prologue=None if pro is None else tuple(map(jnp.asarray, pro)),
        act_pre="relu", plan=plan, h_mode=h_mode, w_mode=w_mode, want_moments=True,
    )
    return np.asarray(y[:, :H], np.float32), np.asarray(s), np.asarray(q)


def _port(x, k, b, pro, dtype, h_mode, w_mode):
    td = getattr(torch, dtype)
    y, (s, q) = conv3x3_fused(
        torch.from_numpy(x).to(td), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(td),
        torch.from_numpy(b), prologue=None if pro is None else tuple(map(torch.from_numpy, pro)),
        act_pre="relu", h_mode=h_mode, w_mode=w_mode, want_moments=True,
    )
    assert y.dtype == td and s.dtype == q.dtype == torch.float32
    return y.float().numpy(), s.numpy(), q.numpy()


def _compare(got, want, dtype):
    (y, s, q), (ry, rs, rq) = got, want
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y, ry, rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(s, rs, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(q, rq, rtol=1e-4, atol=1e-4)
    else:  # chip_smoke.py's measure: the sum against sqrt(H*W*sumsq)
        assert np.all(np.abs(s - rs) <= 1e-3 * np.sqrt(H * W * rq))
        assert np.all(np.abs(q - rq) <= 1e-3 * rq)
    # Both kernels take the moments of the stored value (pallas_conv.py:
    # 763-768), so the moments may differ by no more than the stored outputs
    # do, plus f32 summation order. Moments of the f32 value before the
    # bf16 cast add that cast's rounding, ~1e-3 |y| per element, and fail.
    slack = 1e-5
    dsum = np.abs(y - ry).sum(axis=(1, 2)) + slack * np.abs(ry).sum(axis=(1, 2))
    dsq = np.abs(y**2 - ry**2).sum(axis=(1, 2)) + slack * (ry**2).sum(axis=(1, 2))
    assert np.all(np.abs(s - rs) <= dsum), np.abs(s - rs) / dsum
    assert np.all(np.abs(q - rq) <= dsq), np.abs(q - rq) / dsq


@pytest.mark.parametrize("h_mode", ["reflect", "zero", "wrap"])
@pytest.mark.parametrize("w_mode", ["wrap", "zero", "reflect"])
def test_pad_modes_match_pallas_interpret(h_mode, w_mode):
    x, k, b, pro = _data("float32")
    _compare(_port(x, k, b, pro, "float32", h_mode, w_mode),
             _jax(x, k, b, pro, jnp.float32, h_mode, w_mode), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prologue_matches_pallas_interpret(dtype):
    x, k, b, pro = _data(dtype, seed=1, prologue=True)
    _compare(_port(x, k, b, pro, dtype, "reflect", "wrap"),
             _jax(x, k, b, pro, getattr(jnp, dtype), "reflect", "wrap"), dtype)


@pytest.mark.parametrize("h_mode", ["reflect", "zero", "wrap"])
@pytest.mark.parametrize("w_mode", ["wrap", "zero", "reflect"])
def test_bf16_prologue_pad_modes_match_pallas_interpret(h_mode, w_mode):
    """bf16 with the prologue: both rounding rules (the prologue's result
    cast before the taps, moments of the stored value) at every pad pair."""
    x, k, b, pro = _data("bfloat16", seed=4, prologue=True)
    _compare(_port(x, k, b, pro, "bfloat16", h_mode, w_mode),
             _jax(x, k, b, pro, jnp.bfloat16, h_mode, w_mode), "bfloat16")


def test_bf16_matches_pallas_interpret():
    x, k, b, pro = _data("bfloat16", seed=2)
    _compare(_port(x, k, b, pro, "bfloat16", "zero", "reflect"),
             _jax(x, k, b, pro, jnp.bfloat16, "zero", "reflect"), "bfloat16")


def test_prologue_chain_matches_pallas_interpret():
    """conv0 -> moments -> affine -> conv1 prologue -> moments -> affine +
    residual: the fused resnet block, through both packages' helpers."""
    from biasgan_tpu.ops import pallas_conv as jp

    x, k, b, _ = _data("float32", seed=3)
    y0, s0, q0 = _jax(x, k, b, None, jnp.float32, "reflect", "wrap")
    a0, c0 = jp.instance_moments_to_affine(jnp.asarray(s0), jnp.asarray(q0), H * W)
    y1, s1, q1 = _jax(y0, k, b, (np.asarray(a0), np.asarray(c0)), jnp.float32,
                      "reflect", "wrap")
    a1, c1 = jp.instance_moments_to_affine(jnp.asarray(s1), jnp.asarray(q1), H * W)
    want = np.asarray(jp.apply_affine(jnp.asarray(y1), a1, c1)) + x

    xt, kt = torch.from_numpy(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    bt = torch.from_numpy(b)
    z0, m0 = conv3x3_fused(xt, kt, bt)
    pa, pb = instance_moments_to_affine(*m0, H * W)
    z1, m1 = conv3x3_fused(z0, kt, bt, prologue=(pa, pb))
    pa, pb = instance_moments_to_affine(*m1, H * W)
    got = (apply_affine(z1, pa, pb) + xt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cpu_path_launches_no_kernel_and_checks_arguments():
    x, k, b, _ = _data("float32")
    xt, kt = torch.from_numpy(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    before = conv3x3_fused.launches
    y = conv3x3_fused(xt, kt, None, want_moments=False)
    assert conv3x3_fused.launches == before
    assert tuple(y.shape) == (N, H, W, C)
    with pytest.raises(ValueError, match="OIHW"):
        conv3x3_fused(xt, torch.from_numpy(k.copy()))  # HWIO by mistake
    with pytest.raises(ValueError, match="unknown w_mode 'bogus'"):
        conv3x3_fused(xt, kt, w_mode="bogus")
    with pytest.raises(ValueError, match="unknown h_mode 'halo'"):  # a W mode only
        conv3x3_fused(xt, kt, h_mode="halo")
    with pytest.raises(ValueError, match="reflect"):
        conv3x3_fused(xt[:, :1], kt, h_mode="reflect")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        conv3x3_fused(xt.to("meta"), kt.to("meta"))
