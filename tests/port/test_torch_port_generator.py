"""ResNetGenerator of the PyTorch port against the JAX ResNetGenerator
(ngf 8, 2 blocks, 13x32 input), with the JAX weights converted by
biasgan_tpu_torch/convert.py, f32, to 2e-4 — on the plain path, and on
the fused-block path (the port's conv3x3_fused, on the CPU its plain
version) against the JAX fused path in Pallas interpret mode. Then the
kernel routes (ngf 16, so that the 7x7 stem and head have one tiny channel
side): fused blocks + fused down/up + the 7x7 kernel, and every norm
through the fused instance-norm kernel, against the JAX generator with the
same routes open (interpret mode, or the JAX op's plain reference)."""

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


def _pair(norm, w_mode, fused, ngf=8, h=13, **routes):
    g = ResNetGenerator(
        output_nc=3, ngf=ngf, n_blocks=2, norm_type=norm, use_dropout=False,
        w_mode=w_mode, out_activation="none",
    )
    x = np.random.default_rng(5).normal(size=(1, h, 32, 3)).astype(np.float32)
    v = g.init(jax.random.PRNGKey(1), jnp.asarray(x))
    G = define_G(
        "resnet_2blocks", 3, 3, ngf=ngf, norm=norm, w_mode=w_mode,
        out_activation="none", fused_blocks=fused, **routes,
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
    """Instance norm and no dropout open the fused block path, in training
    too (the differentiable conv3x3_fused_t); the fused down/up path stays
    inference-only, as the JAX gate (generators.py:342)."""
    assert fused_blocks_blocker("instance", False) is None
    assert "instance" in fused_blocks_blocker("batch", False)
    assert "dropout" in fused_blocks_blocker("instance", True)
    _, _, G, x = _pair("instance", "wrap", True, h=16, fused_updown=True)
    assert G.fused_engaged()
    assert G.updown_engaged(torch.from_numpy(x)) == (True, True)
    assert G.train().fused_engaged()
    assert G.updown_engaged(torch.from_numpy(x)) == (False, False)


def test_unported_generators_refuse():
    """The U-Net names build (unet_256: 8 downs); an unknown name still
    refuses."""
    from biasgan_tpu_torch.nn.generators import UNetGenerator

    G = define_G("unet_256", 3, 3, ngf=1)
    assert isinstance(G, UNetGenerator) and G.num_downs == 8
    with pytest.raises(ValueError, match="unknown generator"):
        define_G("bogus", 3, 3)


# the JAX gates that open the same routes on the CPU (interpret mode; the
# fused norm op takes its plain reference off the TPU)
JAX_FUSED = {"BIASGAN_FUSED_BLOCK": "interpret", "BIASGAN_FUSED_MIN_C": "1",
             "BIASGAN_FUSED_TH": "2"}
ROUTES = {
    "fused_all": (dict(fused_updown=True, conv7=True),
                  dict(JAX_FUSED, BIASGAN_CONV7="interpret", BIASGAN_S2D_MIN_M="1")),
    "plain_norm": (dict(fused_norm=True), {"BIASGAN_FORCE_PALLAS_NORM": "1"}),
}


@pytest.mark.parametrize(
    "route,w_mode,h",
    [("fused_all", "wrap", 16),
     ("fused_all", "reflect", 13),  # H % 4 != 0: the fused down path stays off
     ("plain_norm", "wrap", 13), ("plain_norm", "reflect", 16)],
)
def test_generator_kernel_routes_match_jax(route, w_mode, h, monkeypatch):
    port_routes, env = ROUTES[route]
    g, v, G, x = _pair("instance", w_mode, route == "fused_all", ngf=16, h=h,
                       **port_routes)
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    want = np.asarray(g.apply(v, jnp.asarray(x)))
    with torch.inference_mode():
        got = G(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, -(-h // 4) * 4, 32, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("updown", [False, True])
def test_fused_updown_routes_the_down_and_up_convs(updown, monkeypatch):
    """--fused_updown off keeps cuDNN convs + norm_act around the fused
    blocks; on, the two downs and two ups take the fused kernels; the 7x7
    route takes the stem and the head."""
    from biasgan_tpu_torch.nn import layers

    calls = {"conv3x3s2_fused": 0, "convt3x3s2_fused": 0, "conv7x7": 0}
    for name in calls:
        real = getattr(layers, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(layers, name, spy)
    *_, G, x = _pair("instance", "wrap", True, ngf=16, h=16, fused_updown=updown,
                     conv7=True)
    assert G.updown_engaged(torch.from_numpy(x)) == (updown, updown)
    with torch.inference_mode():
        G(torch.from_numpy(x))
    n = 2 if updown else 0
    assert calls == {"conv3x3s2_fused": n, "convt3x3s2_fused": n, "conv7x7": 2}
