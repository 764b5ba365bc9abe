"""The fused stride-2 down conv and up conv-transpose of the PyTorch port
(biasgan_tpu_torch/kernels/conv3x3s2_fused.py, convt3x3s2_fused.py) against
the JAX Pallas kernels they replace (biasgan_tpu/ops/pallas_conv.py::
conv3x3s2_fused, and convt3x3s2_fused + interleave_phases), run as the JAX
package's own tests run them on the CPU: in interpret mode, with a
multi-tile plan whose last tile is partial and, for the conv-transpose, a
sentinel-filled h_run tail (tests/unit/test_fused_updown.py).

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests hold those versions to the Pallas kernels; the CUDA kernels are held
to the plain versions on the card (test_torch_port_cuda.py, chip_smoke.py).

Tolerances: y within f32 1e-4, bf16 2e-2 (|dy| <= tol (1 + |ref|)). The
Pallas kernels cast the prologue's a and b to the input's dtype and compute
in it; the port keeps them in f32 and rounds once, as conv3x3_fused does,
so a bf16 prologue output may differ by an ulp; that moves y far less than
2e-2. Moments within f32
1e-4 relative, and in both dtypes no further from the reference's than the
stored outputs are (|d sum| <= sum |d y| + 1e-5 sum |y|, the same for
sumsq), since both take them from the stored value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.ops.pallas_conv import FusedBlockPlan
from biasgan_tpu.ops.pallas_conv import conv3x3s2_fused as jax_down
from biasgan_tpu.ops.pallas_conv import convt3x3s2_fused as jax_up
from biasgan_tpu.ops.pallas_conv import interleave_phases
from biasgan_tpu_torch.kernels.conv3x3s2_fused import conv3x3s2_fused
from biasgan_tpu_torch.kernels.convt3x3s2_fused import convt3x3s2_fused
from biasgan_tpu_torch.nn import layers as tl

N, C, COUT = 2, 8, 16
H_OUT = 13  # prime: the th=2 plan's last tile holds one row
PLAN = FusedBlockPlan(H_OUT, 2, 14, True)


def _data(h, w, dtype, seed, prologue):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, h, w, C)).astype(np.float32)
    k = (rng.normal(size=(3, 3, C, COUT)) * 0.2).astype(np.float32)  # HWIO
    b = (rng.normal(size=(COUT,)) * 0.1).astype(np.float32)
    pro = None
    if prologue:
        pro = ((rng.random((N, C)) + 0.5).astype(np.float32),
               (rng.normal(size=(N, C)) * 0.5).astype(np.float32))
    return x, k, b, pro


def _jax_pro(pro):
    return None if pro is None else tuple(map(jnp.asarray, pro))


def _torch_pro(pro):
    return None if pro is None else tuple(map(torch.from_numpy, pro))


def _compare(got, want, dtype):
    (y, s, q), (ry, rs, rq) = got, want
    assert y.shape == ry.shape
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.all(np.abs(y - ry) <= tol * (1 + np.abs(ry)))
    if dtype == "float32":
        np.testing.assert_allclose(s, rs, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(q, rq, rtol=1e-4, atol=1e-4)
    dsum = np.abs(y - ry).sum(axis=(1, 2)) + 1e-5 * np.abs(ry).sum(axis=(1, 2))
    dsq = np.abs(y**2 - ry**2).sum(axis=(1, 2)) + 1e-5 * (ry**2).sum(axis=(1, 2))
    assert np.all(np.abs(s - rs) <= dsum), np.abs(s - rs) / dsum
    assert np.all(np.abs(q - rq) <= dsq), np.abs(q - rq) / dsq


CASES = [(d, w, p) for d in ("float32", "bfloat16") for w in ("wrap", "zero") for p in (False, True)]


@pytest.mark.parametrize("dtype,w_mode,prologue", CASES)
def test_down_matches_pallas_interpret(dtype, w_mode, prologue):
    x, k, b, pro = _data(2 * H_OUT, 32, dtype, seed=len(dtype) + prologue, prologue=prologue)
    jd = getattr(jnp, dtype)
    y, (s, q) = jax_down(
        jnp.asarray(x).astype(jd), jnp.asarray(k).astype(jd), jnp.asarray(b),
        prologue=_jax_pro(pro), act_pre="relu", plan=PLAN, w_mode=w_mode,
        want_moments=True,
    )
    want = (np.asarray(y, np.float32), np.asarray(s), np.asarray(q))
    td = getattr(torch, dtype)
    ty, (ts, tq) = conv3x3s2_fused(
        torch.from_numpy(x).to(td), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(td),
        torch.from_numpy(b), prologue=_torch_pro(pro), act_pre="relu", w_mode=w_mode,
    )
    assert ty.dtype == td and ts.dtype == torch.float32
    _compare((ty.float().numpy(), ts.numpy(), tq.numpy()), want, dtype)


@pytest.mark.parametrize("dtype,w_mode,prologue", CASES)
def test_up_matches_pallas_interpret(dtype, w_mode, prologue):
    x, k, b, pro = _data(H_OUT, 16, dtype, seed=10 + len(dtype) + prologue, prologue=prologue)
    jd = getattr(jnp, dtype)
    xj = jnp.asarray(x).astype(jd)
    tail = jnp.full((N, PLAN.h_run - H_OUT, 16, C), 7.75, jd)  # never read
    phases, (s, q) = jax_up(
        jnp.concatenate([xj, tail], axis=1), jnp.asarray(k).astype(jd), jnp.asarray(b),
        prologue=_jax_pro(pro), act_pre="relu", plan=PLAN, w_mode=w_mode,
        want_moments=True,
    )
    y = interleave_phases(phases, H_OUT)
    want = (np.asarray(y, np.float32), np.asarray(s), np.asarray(q))
    td = getattr(torch, dtype)
    ty, (ts, tq) = convt3x3s2_fused(
        torch.from_numpy(x).to(td), torch.from_numpy(k.transpose(2, 3, 0, 1).copy()).to(td),
        torch.from_numpy(b), prologue=_torch_pro(pro), act_pre="relu", w_mode=w_mode,
    )
    assert tuple(ty.shape) == (N, 2 * H_OUT, 32, COUT)
    _compare((ty.float().numpy(), ts.numpy(), tq.numpy()), want, dtype)


@pytest.mark.parametrize("w_mode", ["wrap", "zero"])
def test_plain_versions_match_the_port_layers(w_mode):
    """The plain versions against the port's own conv2d / conv_transpose2d
    (another formulation: a cuDNN-style conv and the dilated periodic
    conv-transpose), f32, no prologue."""
    x, k, b, _ = _data(10, 12, "float32", seed=20, prologue=False)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    oihw = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    got, _ = conv3x3s2_fused(xt, oihw, bt, w_mode=w_mode)
    want = tl.conv2d(xt, oihw, bt, (2, 2), (1, 1), "zero", w_mode)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    k_up = (np.random.default_rng(21).normal(size=(3, 3, C, COUT)) * 0.2).astype(np.float32)
    iohw = torch.from_numpy(k_up.transpose(2, 3, 0, 1).copy())
    got, _ = convt3x3s2_fused(xt, iohw, bt, w_mode=w_mode)
    want = tl.conv_transpose2d(xt, iohw, bt, (2, 2), (1, 1), (1, 1), w_mode=w_mode)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_path_launches_no_kernel_and_checks_arguments():
    x, k, b, _ = _data(10, 12, "float32", seed=22, prologue=False)
    xt = torch.from_numpy(x)
    oihw = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    iohw = torch.from_numpy(k.transpose(2, 3, 0, 1).copy())
    before = (conv3x3s2_fused.launches, convt3x3s2_fused.launches)
    y = conv3x3s2_fused(xt, oihw, want_moments=False)
    z = convt3x3s2_fused(xt, iohw, want_moments=False)
    assert (conv3x3s2_fused.launches, convt3x3s2_fused.launches) == before
    assert tuple(y.shape) == (N, 5, 6, COUT) and tuple(z.shape) == (N, 20, 24, COUT)
    with pytest.raises(ValueError, match="even H and W"):
        conv3x3s2_fused(xt[:, :9], oihw)
    with pytest.raises(ValueError, match="OIHW"):
        conv3x3s2_fused(xt, iohw)
    with pytest.raises(ValueError, match="IOHW"):
        convt3x3s2_fused(xt, oihw)
    for fn, w in ((conv3x3s2_fused, oihw), (convt3x3s2_fused, iohw)):
        with pytest.raises(ValueError, match="w_mode"):
            fn(xt, w, w_mode="reflect")
        with pytest.raises(ValueError, match="runs on cpu or cuda"):
            fn(xt.to("meta"), w.to("meta"))
