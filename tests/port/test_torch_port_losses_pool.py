"""The losses and the replay pool of the PyTorch port against the JAX
package: ``gan_loss`` (vanilla / lsgan / wgangp, real and fake) and
``l1_loss`` in f32 on f32 and bf16 inputs, and ``pool_query`` against the
JAX pool with JAX's own per-image decisions injected: the coin and index
are drawn from the key exactly as the JAX query splits it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu import losses as jax_losses
from biasgan_tpu.utils.image_pool import create_pool as jax_create_pool
from biasgan_tpu.utils.image_pool import pool_query as jax_pool_query
from biasgan_tpu_torch import losses
from biasgan_tpu_torch.utils.image_pool import create_pool, pool_query


@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "wgangp"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gan_loss_matches_jax(mode, real, dtype):
    pred = np.random.default_rng(1).normal(size=(2, 6, 6, 1)).astype(np.float32)
    jp = jnp.asarray(pred, jnp.dtype(dtype))
    tp = torch.from_numpy(pred).to(getattr(torch, dtype))
    want = float(jax_losses.gan_loss(jp, real, mode))
    got = losses.gan_loss(tp, real, mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


def test_l1_and_unknown_mode():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, 5, 5, 3)), rng.normal(size=(2, 5, 5, 3))
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = float(jax_losses.l1_loss(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b)))
    got = float(losses.l1_loss(torch.from_numpy(a).bfloat16(), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="gan_mode"):
        losses.gan_loss(torch.zeros(1), True, "hinge")


def _jax_draws(rng, n, p):
    """The (coin, index) per image of jax pool_query's key splits."""
    out = []
    for key in jax.random.split(rng, n):
        k_coin, k_idx = jax.random.split(key)
        out.append((float(jax.random.uniform(k_coin)), int(jax.random.randint(k_idx, (), 0, p))))
    return out


@pytest.mark.parametrize("pool_size", [0, 3])
def test_pool_matches_jax_with_injected_draws(pool_size):
    """Six queries of a batch of 2 through a 3-slot pool: filling, then
    swaps and pass-throughs, against the JAX pool step by step."""
    rng = np.random.default_rng(4)
    jpool = jax_create_pool(pool_size, (4, 5, 1))
    tpool = create_pool(pool_size, (4, 5, 1))
    for i in range(6):
        imgs = rng.normal(size=(2, 4, 5, 1)).astype(np.float32)
        key = jax.random.PRNGKey(10 + i)
        jpool, jout = jax_pool_query(jpool, jnp.asarray(imgs), key)
        draws = _jax_draws(key, 2, pool_size) if pool_size else None
        tpool, tout = pool_query(tpool, torch.from_numpy(imgs), draws=draws)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tpool.buffer.numpy(), np.asarray(jpool.buffer))
        assert tpool.count == int(jpool.count)


def test_pool_draws_from_a_generator():
    """Without injected draws the decisions come from the generator: the
    same seed gives the same outputs."""
    imgs = [torch.randn(2, 4, 4, 1, generator=torch.Generator().manual_seed(i))
            for i in range(5)]
    outs = []
    for _ in range(2):
        pool, g, out = create_pool(2, (4, 4, 1)), torch.Generator().manual_seed(7), []
        for x in imgs:
            pool, o = pool_query(pool, x, g)
            out.append(o)
        outs.append(torch.stack(out))
    assert torch.equal(outs[0], outs[1])
    assert pool.count == 2
