"""instance_norm_act of the PyTorch port (biasgan_tpu_torch/kernels/
instance_norm_act.py) against the JAX Pallas kernel it replaces
(biasgan_tpu/ops/pallas_fused.py::fused_instance_norm_act), run in interpret
mode as tests/unit/test_pallas.py runs it on the CPU; and the port's
norm_act route (--force_pallas_norm) against the JAX one. On the CPU the
port's wrapper takes its plain PyTorch version, so these tests hold that
version to the Pallas kernel; the CUDA kernel is held to the plain version
on the card (test_torch_port_cuda.py, chip_smoke.py).

Tolerances: f32 1e-5; bf16 2e-2 (|dy| <= tol (1 + |ref|)): the residual is
added in f32 and the result cast once in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu import perf_gates
from biasgan_tpu.nn import layers as jl
from biasgan_tpu.ops.pallas_fused import fused_instance_norm_act
from biasgan_tpu_torch.kernels.instance_norm_act import instance_norm_act
from biasgan_tpu_torch.nn import layers as tl

CASES = [(a, r, d) for a in ("none", "relu", "lrelu") for r in (False, True)
         for d in ("float32", "bfloat16")]


def _data(seed, residual):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 6, 9, 16)) * 3 + 1).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32) if residual else None
    return x, r


def _close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want))), np.abs(got - want).max()


@pytest.mark.parametrize("activation,residual,dtype", CASES)
def test_matches_pallas_interpret(activation, residual, dtype):
    x, r = _data(len(activation) + residual, residual)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = fused_instance_norm_act(
        jnp.asarray(x).astype(jd), None if r is None else jnp.asarray(r).astype(jd),
        activation, 1e-5, True, True,
    )
    got = instance_norm_act(
        torch.from_numpy(x).to(td), None if r is None else torch.from_numpy(r).to(td),
        activation,
    )
    assert got.dtype == td
    _close(got.float().numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("residual", [False, True])
def test_norm_act_route_matches_jax_route(residual, monkeypatch):
    x, r = _data(9, residual)
    with perf_gates.overrides(force_pallas_norm=True):
        want = jl.norm_act(jnp.asarray(x), "instance", "n", activation="relu",
                           residual=None if r is None else jnp.asarray(r))
    calls = []
    monkeypatch.setattr(tl, "instance_norm_act",
                        lambda *a: calls.append(1) or instance_norm_act(*a))
    rt = None if r is None else torch.from_numpy(r)
    got = tl.norm_act(torch.from_numpy(x), tl.InstanceNorm(), "relu", rt, fused=True)
    assert calls == [1]
    _close(got.numpy(), np.asarray(want), "float32")
    tl.norm_act(torch.from_numpy(x), torch.nn.Identity(), "relu", rt, fused=True)
    assert calls == [1]  # only an instance norm takes the kernel


def test_cpu_path_launches_no_kernel_and_checks_arguments():
    x = torch.zeros((1, 4, 4, 8))
    before = instance_norm_act.launches
    instance_norm_act(x, x, "relu")
    assert instance_norm_act.launches == before
    with pytest.raises(ValueError, match="residual must match"):
        instance_norm_act(x, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unknown activation"):
        instance_norm_act(x, None, "tanh")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        instance_norm_act(x.to("meta"))
