"""Ported layers (biasgan_tpu_torch/nn/layers.py) against the JAX layers
they replace (biasgan_tpu/nn/layers.py), on the same numpy inputs, f32,
to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.nn import layers as jl
from biasgan_tpu_torch.nn import layers as tl

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize(
    "h_mode,w_mode,pad",
    [("reflect", "wrap", (2, 3)), ("zero", "reflect", (1, 1)),
     ("wrap", "zero", (3, 0)), ("wrap", "wrap", (9, 11))],  # wrap wider than W
)
def test_pad_hw_matches_jax(h_mode, w_mode, pad):
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = jl.pad_hw(jnp.asarray(x), (1, 2), pad, h_mode, w_mode)
    got = tl.pad_hw(torch.from_numpy(x), (1, 2), pad, h_mode, w_mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "k,s,p,h_mode,w_mode",
    [(7, 1, 3, "reflect", "wrap"), (3, 2, 1, "zero", "wrap"),
     (3, 1, 1, "reflect", "reflect"), (4, 2, 1, "zero", "zero")],
)
def test_conv2d_matches_jax(k, s, p, h_mode, w_mode):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 16, 5)).astype(np.float32)
    w = rng.normal(size=(k, k, 5, 6)).astype(np.float32) * 0.1  # HWIO
    b = rng.normal(size=(6,)).astype(np.float32)
    want = jl.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), (s, s), (p, p),
                     h_mode, w_mode)
    got = tl.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                    torch.from_numpy(b), (s, s), (p, p), h_mode, w_mode)
    _close(got, want)


@pytest.mark.parametrize("w_mode,k,op", [("wrap", 3, 1), ("zero", 3, 1), ("zero", 4, 0),
                                         ("wrap", 4, 0)])
def test_conv_transpose2d_matches_jax(w_mode, k, op):
    """Periodic W (the globe up-path: seam columns included) and zero W."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 8, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 3)).astype(np.float32) * 0.2  # HWIO
    b = rng.normal(size=(3,)).astype(np.float32)
    want = jl.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), (2, 2),
                               (1, 1), (op, op), w_mode=w_mode)
    got = tl.conv_transpose2d(torch.from_numpy(x),
                              torch.from_numpy(w.transpose(2, 3, 0, 1).copy()),
                              torch.from_numpy(b), (2, 2), (1, 1), (op, op), w_mode=w_mode)
    assert tuple(got.shape) == want.shape
    _close(got, want)
    if w_mode == "wrap":  # the dateline seam: first and last output columns
        _close(got[:, :, [0, -1]], np.asarray(want)[:, :, [0, -1]])


def test_conv2d_bf16_compute_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 9, 12, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8, 8)).astype(np.float32) * 0.1
    b = rng.normal(size=(8,)).astype(np.float32)
    want = jl.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), (1, 1), (1, 1),
                     "reflect", "wrap", compute_dtype=jnp.bfloat16)
    got = tl.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                    torch.from_numpy(b), (1, 1), (1, 1), "reflect", "wrap",
                    compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want, np.float32), tol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(dtype):
    x = (np.random.default_rng(4).normal(size=(2, 6, 9, 5)) * 3 + 1).astype(np.float32)
    want = jl.instance_norm(jnp.asarray(x).astype(dtype))
    got = tl.instance_norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got.float(), np.asarray(want, np.float32), tol=TOL if dtype == "float32" else 2e-2)


def test_activations_match_jax():
    x = np.linspace(-2, 2, 17, dtype=np.float32)
    for act in ("none", "relu", "lrelu"):
        _close(tl.apply_activation(torch.from_numpy(x), act),
               jl.apply_activation(jnp.asarray(x), act))


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_make_conv_init_scale(init_type):
    """Same distribution family and scale as the JAX initializer (the two
    frameworks draw different numbers from a seed, so compare the std)."""
    import jax

    shape = (3, 3, 64, 96)
    want = np.asarray(jl.make_conv_init(init_type, 0.02)(jax.random.PRNGKey(0), shape))
    got = tl.make_conv_init(init_type, 0.02)(shape, torch.Generator().manual_seed(0))
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(float(got.std()), float(want.std()), rtol=0.05)
    if init_type == "orthogonal":
        m = got.reshape(-1, shape[-1])
        np.testing.assert_allclose((m.T @ m).numpy(), 0.02**2 * np.eye(shape[-1]),
                                   atol=1e-6)
