"""ResNetGenerator of the PyTorch port against the JAX ResNetGenerator
(ngf 8, 2 blocks, 13x32 input), with the JAX weights converted by
biasgan_tpu_torch/convert.py, f32, to 2e-4 — on the plain path, and on
the fused-block path (the port's conv3x3_fused, on the CPU its plain
version) against the JAX fused path in Pallas interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.nn.generators import ResNetGenerator
from biasgan_tpu_torch.convert import params_to_state_dict
from biasgan_tpu_torch.nn import define_G
from biasgan_tpu_torch.nn.generators import fused_blocks_blocker

TOL = 2e-4


def _pair(norm, w_mode, fused):
    g = ResNetGenerator(
        output_nc=3, ngf=8, n_blocks=2, norm_type=norm, use_dropout=False,
        w_mode=w_mode, out_activation="none",
    )
    x = np.random.default_rng(5).normal(size=(1, 13, 32, 3)).astype(np.float32)
    v = g.init(jax.random.PRNGKey(1), jnp.asarray(x))
    G = define_G(
        "resnet_2blocks", 3, 3, ngf=8, norm=norm, w_mode=w_mode,
        out_activation="none", fused_blocks=fused,
    )
    G.load_state_dict(params_to_state_dict(v["params"], v.get("batch_stats")))
    return g, v, G.eval(), x


@pytest.mark.parametrize(
    "norm,w_mode,fused",
    [("instance", "wrap", False), ("instance", "wrap", True),
     ("instance", "reflect", False), ("instance", "reflect", True),
     ("batch", "wrap", False)],
)
def test_generator_matches_jax(norm, w_mode, fused, monkeypatch):
    g, v, G, x = _pair(norm, w_mode, fused)
    if fused:
        # the JAX fused path in interpret mode (tests/unit/test_fused_block.py)
        monkeypatch.setenv("BIASGAN_FUSED_BLOCK", "interpret")
        monkeypatch.setenv("BIASGAN_FUSED_MIN_C", "1")
        monkeypatch.setenv("BIASGAN_FUSED_TH", "2")
    want = np.asarray(g.apply(v, jnp.asarray(x)))
    assert G.fused_engaged() == fused
    with torch.inference_mode():
        got = G(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 16, 32, 3)  # 13 rows -> 4 -> 16
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_fused_gate_follows_jax_eligibility():
    assert fused_blocks_blocker("instance", False, False) is None
    assert "instance" in fused_blocks_blocker("batch", False, False)
    assert "dropout" in fused_blocks_blocker("instance", True, False)
    assert "training" in fused_blocks_blocker("instance", False, True)
    _, _, G, _ = _pair("instance", "wrap", True)
    assert G.fused_engaged()
    assert not G.train().fused_engaged()


def test_unported_generators_refuse():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        define_G("unet_256", 3, 3)
    with pytest.raises(ValueError, match="unknown generator"):
        define_G("bogus", 3, 3)
