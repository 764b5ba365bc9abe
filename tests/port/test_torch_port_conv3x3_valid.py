"""The VALID 3x3 conv (K6) of the PyTorch port against the JAX package:
``conv3x3_valid_plain`` (what the wrapper runs on the CPU) against the
Pallas ``conv3x3_valid`` in interpret mode over its epilogue variants in
f32 and bf16, and ``conv3x3_op``'s gradients against ``jax.grad`` of the
JAX ``conv3x3_op`` (whose input gradient runs the same Pallas kernel).
Output widths are multiples of 8, which the Pallas kernel requires.
Tolerances: f32 2e-5 relative / 2e-4 absolute (the JAX fused-train tests'
bound); bf16 2e-2, one bf16 rounding apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.ops.pallas_conv import conv3x3_op as jax_conv3x3_op
from biasgan_tpu.ops.pallas_conv import conv3x3_valid as jax_conv3x3_valid
from biasgan_tpu_torch.kernels import conv3x3_valid as port
from biasgan_tpu_torch.kernels.conv3x3_valid import conv3x3_op, conv3x3_valid

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, n=2, h=5, w=8, c=8, cout=16):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(n, h + 2, w + 2, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, cout)) / (9 * c) ** 0.5).astype(np.float32)  # HWIO
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    res = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    return xp, k, bias, res


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "bias,residual,act",
    [(False, False, "none"), (True, False, "relu"), (True, True, "lrelu"), (False, True, "none")],
)
def test_plain_matches_pallas_kernel(dtype, bias, residual, act):
    jdt, tdt = DTYPES[dtype]
    xp, k, b, r = _case(1, w=16 if residual else 8)
    want = jax_conv3x3_valid(
        jnp.asarray(xp, jdt), jnp.asarray(k, jdt), jnp.asarray(b) if bias else None,
        jnp.asarray(r, jdt) if residual else None, act, interpret=True,
    )
    got = conv3x3_valid(
        torch.from_numpy(xp).to(tdt), _oihw(k).to(tdt), torch.from_numpy(b) if bias else None,
        torch.from_numpy(r).to(tdt) if residual else None, act,
    )
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bias", [False, True])
def test_op_grads_match_jax(bias):
    xp, k, b, _ = _case(2, n=2, h=6, w=8, c=8, cout=16)
    g = np.random.default_rng(3).normal(size=(2, 6, 8, 16)).astype(np.float32)

    def jloss(xp, k, b):
        return jnp.sum(jax_conv3x3_op(xp, k, b if bias else None, True) * g)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jnp.asarray(xp), jnp.asarray(k),
                                                          jnp.asarray(b))
    txp = torch.from_numpy(xp).requires_grad_(True)
    tk = _oihw(k).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    before = (port.conv3x3_valid.launches, port.conv3x3_valid.bwd_launches)
    y = conv3x3_op(txp, tk, tb if bias else None)
    assert y.grad_fn is not None
    tv = (y * torch.from_numpy(g)).sum()
    tv.backward()
    # the CPU runs the plain version: no kernel launch is counted
    assert (port.conv3x3_valid.launches, port.conv3x3_valid.bwd_launches) == before
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(txp.grad.numpy(), np.asarray(jg[0]), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(tk.grad.numpy().transpose(2, 3, 1, 0), np.asarray(jg[1]),
                               rtol=2e-5, atol=2e-4)
    if bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[2]), rtol=2e-5, atol=2e-4)


def test_op_grads_bf16_match_jax():
    """bf16: the input grad runs the kernel's plain version in bf16 storage,
    the weight grad a bf16 conv, as the JAX backward does."""
    xp, k, b, _ = _case(4, n=1, h=4, w=8, c=8, cout=8)
    g = np.random.default_rng(5).normal(size=(1, 4, 8, 8)).astype(np.float32)

    def jloss(xp, k):
        y = jax_conv3x3_op(xp.astype(jnp.bfloat16), k.astype(jnp.bfloat16), None, True)
        return jnp.sum(y.astype(jnp.float32) * g)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(k))
    txp = torch.from_numpy(xp).requires_grad_(True)
    tk = _oihw(k).requires_grad_(True)
    y = conv3x3_op(txp.to(torch.bfloat16), tk.to(torch.bfloat16))
    (y.float() * torch.from_numpy(g)).sum().backward()
    for got, want in ((txp.grad.numpy(), np.asarray(jg[0])),
                      (tk.grad.numpy().transpose(2, 3, 1, 0), np.asarray(jg[1]))):
        np.testing.assert_allclose(got, want, atol=0.05 * max(1.0, np.abs(want).max()),
                                   rtol=0.1)


def test_epilogue_variants_refuse_grad_on_the_card(monkeypatch):
    """Where the kernel runs (the device check is faked: the dispatch is
    what is under test) and autograd records, the bare form goes through
    conv3x3_op (a grad_fn, forward and input grad on the kernel) and the
    residual / activation forms, which the JAX op does not differentiate,
    raise instead of returning a result with no grad_fn."""
    xp, k, _, _ = _case(6)
    calls = []

    def fake_launch(xp, w, bias, res, act, bwd=False):
        calls.append(bwd)
        return torch.zeros((xp.shape[0], xp.shape[1] - 2, xp.shape[2] - 2, w.shape[0]))

    monkeypatch.setattr(port, "check_device", lambda *a: False)
    monkeypatch.setattr(port, "_launch", fake_launch)
    txp = torch.from_numpy(xp).requires_grad_(True)
    tk = _oihw(k).requires_grad_(True)
    y = conv3x3_valid(txp, tk)
    assert y.grad_fn is not None
    y.sum().backward()
    assert calls == [False, True]  # the forward, then the input gradient
    with pytest.raises(RuntimeError, match="no backward"):
        conv3x3_valid(txp, tk, activation="relu")
    with torch.no_grad():
        assert conv3x3_valid(txp, tk, activation="relu").grad_fn is None
