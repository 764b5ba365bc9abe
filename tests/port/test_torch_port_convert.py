"""Weight bridge of the PyTorch port (biasgan_tpu_torch/convert.py):
random ResNetGenerator params survive JAX -> port state_dict -> JAX
bit-exact, the port's reverse direction agrees with the JAX package's own
torch importer (utils/torch_import.py::convert_state_dict), and the
converted state_dict loads strictly into the port's generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from biasgan_tpu.nn.generators import ResNetGenerator
from biasgan_tpu.utils.torch_import import convert_state_dict
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.nn import define_G


def _init(norm, w_mode="wrap"):
    g = ResNetGenerator(
        output_nc=3, ngf=8, n_blocks=2, norm_type=norm, use_dropout=False,
        w_mode=w_mode,
    )
    x = jnp.zeros((1, 16, 16, 2))
    v = g.init(jax.random.PRNGKey(3), x)
    params = jax.tree_util.tree_map(np.asarray, dict(v["params"]))
    stats = jax.tree_util.tree_map(np.asarray, dict(v.get("batch_stats", {})))
    if stats:  # non-trivial running stats, so a swap would show
        rng = np.random.default_rng(0)
        stats = jax.tree_util.tree_map(
            lambda a: (rng.random(a.shape) + 0.5).astype(np.float32), stats
        )
    return params, stats


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_round_trip_is_bit_exact(norm):
    params, stats = _init(norm)
    sd = params_to_state_dict(params, stats)
    p2, s2 = state_dict_to_params(sd)
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, stats)


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_agrees_with_reference_importer(norm):
    params, stats = _init(norm)
    sd = params_to_state_dict(params, stats)
    ref_p, ref_s = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    _assert_trees_equal(ref_p, params)
    _assert_trees_equal(ref_s, stats)
    mine_p, mine_s = state_dict_to_params(sd)
    _assert_trees_equal(mine_p, ref_p)
    _assert_trees_equal(mine_s, ref_s)


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_state_dict_loads_into_port_generator(norm):
    params, stats = _init(norm)
    sd = params_to_state_dict(params, stats)
    G = define_G("resnet_2blocks", 2, 3, ngf=8, norm=norm, w_mode="wrap")
    assert set(G.state_dict()) == set(sd)
    G.load_state_dict(sd)  # strict
    # layouts: conv OIHW, convT IOHW
    np.testing.assert_array_equal(
        G.blocks[1].conv0.weight.detach().numpy(),
        params["block1"]["conv0"]["kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        G.up0.weight.detach().numpy(),
        params["up0"]["kernel"].transpose(2, 3, 0, 1),
    )
