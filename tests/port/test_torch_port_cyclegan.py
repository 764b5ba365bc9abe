"""The CycleGAN training step of the PyTorch port against the JAX
``make_train_step``: the same weights (JAX's, converted), the same batches,
three steps, f32, no pool and no augmentation (the two packages' random
streams cannot be matched; the pool is held to JAX's on its own in
test_torch_port_losses_pool.py), on the plain route and on the fused-block
route (the JAX kernels in interpret mode). Held: each step's losses at
rtol 2e-4 (tests/unit/test_fused_train.py:236-240), the step-1 outputs of
the Gs and the step-1 G and D gradients (both steps' ``debug_grads``), and
the Adam moments after the three steps.

The crop is 64: at 32 the D's last instance norms see 3x3 and 4x4 maps,
and at initialization its gradients then move by ~5% under the 1e-6
rounding differences of the fakes, in either package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.models.cyclegan import CycleGANModel
from biasgan_tpu.models.cyclegan import create_state as jax_create_state
from biasgan_tpu.models.cyclegan import make_train_step as jax_make_train_step
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.models.cyclegan import build_nets, create_state, make_train_step

ARGS = [
    "--model", "cycle_gan", "--dataset_mode", "synthetic", "--netG", "resnet_2blocks",
    "--crop_size", "64", "--input_nc", "1", "--output_nc", "1", "--batch_size", "2",
    "--ngf", "8", "--ndf", "8", "--norm", "instance", "--pool_size", "0",
    "--no-in_graph_aug", "--n_epochs", "1", "--n_epochs_decay", "1",
]
K = 3


def _by_net(named):
    """{'G_A.stem.weight': t, ...} -> {'G_A': params tree, ...}."""
    nets = {}
    for name, t in named.items():
        net, key = name.split(".", 1)
        nets.setdefault(net, {})[key] = t
    return {net: state_dict_to_params(sd)[0] for net, sd in nets.items()}


def _close(got, want, rtol, atol_frac, what):
    """Leaf by leaf, within rtol and atol_frac of the largest |value| of the
    whole tree (a bias ahead of an instance norm has a zero gradient in
    exact arithmetic, so its own scale is rounding noise)."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g), what
    atol = atol_frac * max(float(np.abs(np.asarray(v)).max()) for _, v in flat_w)
    for path, wv in flat_w:
        wv = np.asarray(wv)
        np.testing.assert_allclose(np.asarray(flat_g[path]), wv, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_cyclegan_steps_match_jax(route, tmp_path, monkeypatch):
    argv = ARGS + ["--checkpoints_dir", str(tmp_path), "--name", route]
    jcfg = jax_parse_config(argv, train=True)
    cfg = parse_config(argv + ["--device", "cpu"], train=True)
    jcfg.steps_per_epoch = cfg.steps_per_epoch = 2
    if route == "fused":
        for k, v in {"BIASGAN_FUSED_BLOCK": "interpret", "BIASGAN_FUSED_TRAIN": "1",
                     "BIASGAN_FUSED_MIN_C": "1"}.items():
            monkeypatch.setenv(k, v)
        cfg.fused_blocks = True

    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0))
    nets = build_nets(cfg)
    for name, net in nets.items():
        net.load_state_dict(params_to_state_dict(jstate.nets[name]["params"]))
    state = create_state(cfg, torch.device("cpu"), nets)
    jstep = jax.jit(jax_make_train_step(jcfg, debug_grads=True))
    step = make_train_step(cfg, debug_grads=True)

    rng = np.random.default_rng(1)
    for i in range(K):
        a = rng.normal(size=(2, 64, 64, 1)).astype(np.float32)
        b = np.tanh(rng.normal(size=(2, 64, 64, 1))).astype(np.float32)
        jstate, jl, jv = jstep(jstate, {"A": jnp.asarray(a), "B": jnp.asarray(b)},
                               jax.random.PRNGKey(2 + i))
        tl, tv = step(state, {"A": torch.from_numpy(a), "B": torch.from_numpy(b)})
        assert list(tl) == CycleGANModel.loss_names
        for k in jl:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=2e-4, atol=1e-6,
                                       err_msg=f"step {i + 1} loss {k}")
        if i == 0:
            _close(_by_net(tv["_g_grads"]), jv["_g_grads"], 2e-4, 5e-4, "step-1 G grads")
            for k in ("fake_B", "fake_A", "rec_A", "rec_B"):
                np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), rtol=2e-4,
                                           atol=2e-4, err_msg=k)
            _close(_by_net(tv["_d_grads"]), jv["_d_grads"], 2e-4, 5e-4, "step-1 D grads")
    assert state.step == int(jstate.step) == K
    for opt in ("G", "D"):
        jopt = jstate.opts[opt]
        assert state.opts[opt].count == int(jopt.count) == K
        _close(_by_net(state.opts[opt].mu), jopt.mu, 1e-3, 1e-3, f"{opt} Adam mu")
        _close(_by_net(state.opts[opt].nu), jopt.nu, 2e-3, 1e-3, f"{opt} Adam nu")
