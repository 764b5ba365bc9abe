"""The discriminators of the PyTorch port against the JAX package's: the
JAX weights converted by biasgan_tpu_torch/convert.py (and back, bit-exact)
into NLayerDiscriminator ('basic', 'n_layers') and PixelDiscriminator,
forward at 2e-4 in f32 and the bf16 compute-dtype rule in bf16, with the
instance norms on the plain path and through the fused-norm kernel's plain
version (the JAX --force_pallas_norm route)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.nn.factory import define_D as jax_define_D
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.nn import define_D

TOL = 2e-4


def _pair(netD, norm, w_mode="zero", dtype="float32", fused_norm=False, n_layers=3):
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    d = jax_define_D(netD, ndf=8, n_layers_D=n_layers, norm=norm, w_mode=w_mode,
                     compute_dtype=jdt)
    x = np.random.default_rng(3).normal(size=(2, 32, 40, 3)).astype(np.float32)
    v = d.init(jax.random.PRNGKey(4), jnp.asarray(x), False)
    D = define_D(netD, 3, ndf=8, n_layers_D=n_layers, norm=norm, w_mode=w_mode,
                 compute_dtype=tdt, fused_norm=fused_norm)
    D.load_state_dict(params_to_state_dict(v["params"], v.get("batch_stats")))
    return d, v, D, x


@pytest.mark.parametrize(
    "netD,norm,w_mode,n_layers",
    [("basic", "instance", "zero", 3), ("basic", "instance", "wrap", 3),
     ("n_layers", "instance", "zero", 2), ("pixel", "instance", "zero", 3),
     ("basic", "batch", "zero", 3), ("pixel", "none", "zero", 3)],
)
def test_discriminator_matches_jax(netD, norm, w_mode, n_layers):
    d, v, D, x = _pair(netD, norm, w_mode, n_layers=n_layers)
    want = np.asarray(d.apply(v, jnp.asarray(x), False))
    with torch.no_grad():
        got = D.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_discriminator_fused_norm_and_dtype(dtype, monkeypatch):
    """--force_pallas_norm reaches the D's norms in JAX too (its gate is
    global); in bf16 both packages run the convs in bf16."""
    d, v, D, x = _pair("basic", "instance", dtype=dtype, fused_norm=True)
    monkeypatch.setenv("BIASGAN_FORCE_PALLAS_NORM", "1")
    want = np.asarray(d.apply(v, jnp.asarray(x), True), np.float32)
    with torch.no_grad():
        got = D.train()(torch.from_numpy(x)).float().numpy()
    tol = TOL if dtype == "float32" else 2e-2 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_discriminator_weights_round_trip():
    """JAX params -> port state_dict -> JAX params is bit-exact, and the
    module names are the torch oracle's."""
    _, v, D, _ = _pair("basic", "batch")
    names = {k.rsplit(".", 1)[0] for k in D.state_dict()}
    assert names == {"convs.0", "convs.1", "convs.2", "convs.3", "norms.1", "norms.2",
                     "norms.3", "out"}
    params, stats = state_dict_to_params(D.state_dict())
    for want, got in ((v["params"], params), (v["batch_stats"], stats)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(flat_g[path], np.asarray(leaf))


def test_unknown_discriminator_refuses():
    with pytest.raises(ValueError, match="unknown discriminator"):
        define_D("bogus", 3)
