"""conv7x7 of the PyTorch port (biasgan_tpu_torch/kernels/conv7x7.py)
against the JAX Pallas kernel it replaces (biasgan_tpu/ops/pallas_conv7.py::
conv7x7_valid), run as tests/unit/test_pallas_conv7.py runs it on the CPU:
in interpret mode. On the CPU the port's wrapper takes its plain PyTorch
version, so these tests hold that version to the Pallas kernel; the CUDA
kernel is held to the plain version on the card (test_torch_port_cuda.py,
chip_smoke.py).

A seeded sweep covers both variants: every Cin from 1 to 8 (smallcin) and
every Cout from 1 to 8 with a wider Cin (smallcout), at odd H and W. Then
the conv2d route (--conv7_pallas) against the JAX route. Tolerances: f32
1e-5 on y (both accumulate in f32), bf16 2e-2 (|dy| <= tol (1 + |ref|)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu import perf_gates
from biasgan_tpu.nn import layers as jl
from biasgan_tpu.ops.pallas_conv7 import conv7x7_valid
from biasgan_tpu_torch.kernels.conv7x7 import conv7x7
from biasgan_tpu_torch.nn import layers as tl


def _sweep():
    rng = np.random.default_rng(7)
    cases = []
    for cin in range(1, 9):  # smallcin
        cases.append((cin, int(rng.choice([1, 5, 8, 16, 24])), "float32"))
    for cout in range(1, 9):  # smallcout
        cases.append((int(rng.choice([9, 16, 40])), cout, "float32"))
    cases += [(3, 16, "bfloat16"), (16, 3, "bfloat16")]
    return [(cin, cout, int(rng.choice([5, 9, 11])), int(rng.choice([7, 13, 17])), dt)
            for cin, cout, dt in cases]


@pytest.mark.parametrize("cin,cout,h,w,dtype", _sweep())
def test_conv7x7_matches_pallas_interpret(cin, cout, h, w, dtype):
    rng = np.random.default_rng(cin * 100 + cout)
    xp = rng.normal(size=(2, h + 6, w + 6, cin)).astype(np.float32)
    k = (rng.normal(size=(7, 7, cin, cout)) * 0.1).astype(np.float32)  # HWIO
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    jd = getattr(jnp, dtype)
    want = np.asarray(
        conv7x7_valid(jnp.asarray(xp).astype(jd), jnp.asarray(k).astype(jd),
                      jnp.asarray(b), interpret=True), np.float32)
    td = getattr(torch, dtype)
    got = conv7x7(torch.from_numpy(xp).to(td),
                  torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(td),
                  torch.from_numpy(b))
    assert got.dtype == td and tuple(got.shape) == (2, h, w, cout)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.all(np.abs(got.float().numpy() - want) <= tol * (1 + np.abs(want)))


@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 3)])
def test_conv2d_route_matches_jax_route(cin, cout, monkeypatch):
    """conv2d(conv7=True) takes the kernel for the stem and head shapes and
    matches the JAX route (--conv7_pallas interpret); a 3x3 conv stays on
    the plain conv."""
    rng = np.random.default_rng(cin)
    x = rng.normal(size=(1, 12, 20, cin)).astype(np.float32)
    k = (rng.normal(size=(7, 7, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    with perf_gates.overrides(conv7_pallas="interpret", s2d_min_m=1):
        want = jl.conv2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), (1, 1), (3, 3),
                         "reflect", "wrap")
    calls = []
    monkeypatch.setattr(tl, "conv7x7", lambda *a: calls.append(1) or conv7x7(*a))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    got = tl.conv2d(xt, torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), bt, (1, 1),
                    (3, 3), "reflect", "wrap", conv7=True)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    k3 = torch.from_numpy((rng.normal(size=(cout, cin, 3, 3)) * 0.1).astype(np.float32))
    tl.conv2d(xt, k3, bt, (1, 1), (1, 1), "reflect", "wrap", conv7=True)
    assert calls == [1]


def test_conv7x7_refuses_what_the_kernels_refuse():
    xp = torch.zeros((1, 10, 10, 16))
    before = conv7x7.launches
    assert tuple(conv7x7(xp, torch.zeros((3, 16, 7, 7))).shape) == (1, 4, 4, 3)
    assert conv7x7.launches == before
    with pytest.raises(ValueError, match="neither side tiny"):
        conv7x7(xp, torch.zeros((16, 16, 7, 7)))
    with pytest.raises(ValueError, match="OIHW"):
        conv7x7(xp, torch.zeros((7, 7, 16, 3)))
    assert not tl.conv7_eligible((8, 3, 7, 7), (1, 1), (3, 3))  # both sides tiny
    assert tl.conv7_eligible((64, 3, 7, 7), (1, 1), (3, 3))
    assert not tl.conv7_eligible((64, 3, 7, 7), (2, 2), (3, 3))
