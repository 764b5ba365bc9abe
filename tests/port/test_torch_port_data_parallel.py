"""Data-parallel training in the port, on the CPU: the pix2pix and CycleGAN
steps under a ``DataCtx`` on 2 spawned gloo ranks (one spawn carries every
case), against the JAX step under ``data_parallel_step`` on
``make_mesh(data=2)`` of the conftest's virtual devices, and (instance
norm) against the port's one-device step on the global batch.

Cases (the models of tests/distributed/test_data_parallel.py:42, :89,
:100, :119): pix2pix unet_d4, basic D, ngf / ndf 8, 32x32, 1 channel,
global batch 4, no dropout, no augmentation, with instance norm and with
batch norm in lsgan, and batch norm in wgangp with JAX's alpha per rank
(``split(fold_in(key, rank))[1]``, the folded key of the JAX step) handed
to each rank; CycleGAN resnet_3blocks at 64x64 (at 32 the Ds' last norms
see 3x3 maps), global batch 2, pool 4 (it fills, so no pool draw enters).
Both packages start from the same weights: the port's seeded nets,
converted for JAX. One step.

Held: losses rtol 2e-4; the averaged grads' global norms rtol 1e-3
(pix2pix: the steps' debug norms; CycleGAN: Adam's first moment after the
step, (1 - b1) g); Adam's first moment leaf by leaf at rtol 1e-3 and 1e-3
of the tree's largest |value| (a bias ahead of an instance norm has a zero
gradient in exact arithmetic); the running averages at rtol 1e-3 and 1e-4
of the tree's largest |value|; the parameters within atol 1.5e-3 (Adam's
first step moves each by ~lr whatever its gradient: the spatial test's
rule, which adds a noise floor only for a second step); the pools at 5e-4;
every rank's state, the pools included, bitwise rank 0's. A missing mean,
a sum in place of a mean, or the wrong slice moves the grad norms by about
sqrt(2) or 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.models import cyclegan as jcg
from biasgan_tpu.models import pix2pix as jp2p
from biasgan_tpu.models.common import adam_transform_of, init_state
from biasgan_tpu.parallel import data_parallel_step, make_mesh, shard_batch
from biasgan_tpu.utils.image_pool import create_pool
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.models.common import step_generator
from biasgan_tpu_torch.parallel import spawn
from biasgan_tpu_torch.parallel.checks import data_cases
from biasgan_tpu_torch.registry import get_model

N = 2
LOSS_RTOL, NORM_RTOL, PARAM_ATOL, POOL_TOL = 2e-4, 1e-3, 1.5e-3, 5e-4
SPAWN_TIMEOUT_S = 300
P2P = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--netG", "unet_d4",
    "--netD", "basic", "--crop_size", "32", "--input_nc", "1", "--output_nc", "1",
    "--batch_size", "4", "--ngf", "8", "--ndf", "8", "--no_dropout", "--no-in_graph_aug",
    "--n_epochs", "1", "--n_epochs_decay", "1",
]
CG = [
    "--model", "cycle_gan", "--dataset_mode", "synthetic", "--netG", "resnet_3blocks",
    "--netD", "basic", "--norm", "instance", "--no_dropout", "--gan_mode", "lsgan",
    "--pool_size", "4", "--crop_size", "64", "--input_nc", "1", "--output_nc", "1",
    "--batch_size", "2", "--ngf", "8", "--ndf", "8", "--no-in_graph_aug",
    "--n_epochs", "1", "--n_epochs_decay", "1",
]
CASES = {
    "p2p_instance_lsgan": P2P + ["--norm", "instance", "--gan_mode", "lsgan"],
    "p2p_batch_lsgan": P2P + ["--norm", "batch", "--gan_mode", "lsgan"],
    "p2p_batch_wgangp": P2P + ["--norm", "batch", "--gan_mode", "wgangp"],
    "cyclegan_pool": CG,
}
KEY = 7  # the JAX step key: jax.random.PRNGKey(KEY)


def _batch(argv):
    cfg = parse_config(argv + ["--device", "cpu"], train=True)
    rng = np.random.default_rng(3)
    shape = (cfg.batch_size, cfg.crop_size, cfg.crop_size, 1)
    a = rng.normal(size=shape).astype(np.float32)
    return {"A": a, "B": np.tanh(1.3 * a + 0.2).astype(np.float32)}


def _alphas(b_local):
    """The JAX data-parallel step's alpha on each rank."""
    key = jax.random.PRNGKey(KEY)
    return [np.asarray(jax.random.uniform(
        jax.random.split(jax.random.fold_in(key, r))[1], (b_local, 1, 1, 1)))
        for r in range(N)]


def _port_case(name):
    argv = CASES[name] + ["--device", "cpu"]
    case = {"argv": argv, "batches": [_batch(CASES[name])]}
    if name.endswith("wgangp"):
        case["gp_alpha"] = [_alphas(4 // N)]
    return case


# the draws of each rank (the test's docstring): a resnet G (dropout in its
# blocks; unet_d4 has no dropout layer), dropout on, twice, and off, on a
# global batch whose two halves are the same samples
DROP_G = P2P + ["--netG", "resnet_3blocks", "--norm", "batch"]
DRAWS = {"dropout": DROP_G + ["--no-no_dropout"],
         "dropout_again": DROP_G + ["--no-no_dropout"],
         "no_dropout": DROP_G}


def _draws_case(name):
    half = {k: v[:2] for k, v in _batch(DRAWS[name]).items()}
    batch = {k: np.concatenate([v, v]) for k, v in half.items()}
    return {"argv": DRAWS[name] + ["--device", "cpu"], "batches": [batch, batch],
            "fakes": True}


@pytest.fixture(scope="module")
def ranks():
    """Every case on 2 gloo ranks, in one spawn."""
    cases = [_port_case(k) for k in CASES] + [_draws_case(k) for k in DRAWS]
    res = spawn(data_cases, N, (cases,), timeout=SPAWN_TIMEOUT_S,
                group_timeout=SPAWN_TIMEOUT_S)
    return dict(zip(list(CASES) + list(DRAWS), res))


def _jax_state(jcfg, cfg):
    """The JAX train state of the port's seeded nets (converted), fresh
    Adam states and pools."""
    state = get_model(cfg.model).create_state(cfg, torch.device("cpu"))
    nets, params = {}, {}
    for name, net in state.nets.items():
        p, stats = jax.tree_util.tree_map(jnp.asarray, state_dict_to_params(
            {k: v for k, v in net.state_dict().items()
             if not k.endswith("num_batches_tracked")}))
        nets[name] = {"params": p, **({"batch_stats": stats} if stats else {})}
        params[name] = p
    tx = adam_transform_of(jcfg)
    if cfg.model == "pix2pix":
        return init_state(nets, {k: (tx, params[k]) for k in ("G", "D")})
    s, c = cfg.crop_size, cfg.input_nc
    return init_state(
        nets, {"G": (tx, {k: params[k] for k in ("G_A", "G_B")}),
               "D": (tx, {k: params[k] for k in ("D_A", "D_B")})},
        pools={k: create_pool(cfg.pool_size, (s, s, c)) for k in ("fake_B", "fake_A")})


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each case's JAX data-parallel step on 2 virtual devices: (losses,
    state after)."""
    mesh = make_mesh(data=N)
    out = {}
    for name, argv in CASES.items():
        path = str(tmp_path_factory.mktemp(name))
        jcfg = jax_parse_config(argv + ["--checkpoints_dir", path, "--name", "j"], train=True)
        cfg = parse_config(argv + ["--device", "cpu"], train=True)
        jcfg.steps_per_epoch = cfg.steps_per_epoch = 2
        if cfg.model == "pix2pix":
            fn = jp2p.make_train_step(jcfg, axis_name="data", debug_grad_norms=True)
        else:
            fn = jcg.make_train_step(jcfg, axis_name="data")
        step = jax.jit(data_parallel_step(fn, mesh))
        batch = shard_batch({k: jnp.asarray(v) for k, v in _batch(argv).items()}, mesh)
        state, losses, _ = step(_jax_state(jcfg, cfg), batch, jax.random.PRNGKey(KEY))
        out[name] = ({k: float(v) for k, v in losses.items()}, state)
    return out


def _sd(tree, stats=None):
    return {k: v.numpy() for k, v in params_to_state_dict(tree, stats).items()
            if not k.endswith("num_batches_tracked")}


def _close(got, want, rtol, atol_frac, what):
    """Leaf by leaf, within rtol and atol_frac of the tree's largest
    |value|."""
    assert sorted(got) == sorted(want), what
    atol = atol_frac * max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def _mu_by_net(mu):
    """The port's Adam moments {'net.param': array} by net."""
    out = {}
    for k, v in mu.items():
        net, name = k.split(".", 1)
        out.setdefault(net, {})[name] = v
    return out


def _norm(trees, b1=0.5):
    """The global L2 norm of the grads behind Adam's first moments."""
    return float(np.sqrt(sum(float(np.square(v.astype(np.float64)).sum())
                             for t in trees for v in t.values()))) / (1 - b1)


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_step_matches_jax(ranks, jax_runs, name):
    got = ranks[name]
    jl, jstate = jax_runs[name]
    assert got["params_equal"], "the ranks' state differs"
    assert all(v == 0 for counts in got["launches"] for v in counts.values())
    (losses,) = got["losses"]
    model = get_model(jax_parse_config(CASES[name], train=True).model)
    for k in model.loss_names:
        np.testing.assert_allclose(losses[k], jl[k], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=f"{name} loss {k}")
    mus = {}
    for opt, o in got["mu"].items():
        port = _mu_by_net(o)
        jmu = jstate.opts[opt].mu
        want = ({opt: _sd(jmu)} if name.startswith("p2p") else
                {net: _sd(jmu[net]) for net in port})
        for net in port:
            _close(port[net], want[net], 1e-3, 1e-3, f"{name} Adam mu {net}")
        mus[opt] = (port, want)
    for opt, key in (("G", "g_grad_norm"), ("D", "d_grad_norm")):
        port, want = mus[opt]
        np.testing.assert_allclose(_norm(port.values()), _norm(want.values()), rtol=NORM_RTOL,
                                   err_msg=f"{name} {opt} grad norm")
        if key in jl:  # pix2pix: the step's own debug norms, of the averaged grads
            np.testing.assert_allclose(losses[key], jl[key], rtol=NORM_RTOL,
                                       err_msg=f"{name} {key}")
            np.testing.assert_allclose(losses[key], _norm(port.values()), rtol=1e-5)
    for net, v in jstate.nets.items():
        want = _sd(v["params"], v.get("batch_stats"))
        stats = [k for k in want if "running" in k]
        assert bool(stats) == ("batch" in name)
        have = got["nets"][net]
        if stats:
            _close({k: have[k] for k in stats}, {k: want[k] for k in stats}, 1e-3, 1e-4,
                   f"{name} {net} running averages")
        for k in want:
            if k not in stats:
                np.testing.assert_allclose(have[k], want[k], rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"{name} {net}.{k}")
    for k, p in jstate.pools.items():
        assert int(p.count) == 2
        np.testing.assert_allclose(got["pools"][k], np.asarray(p.buffer), rtol=POOL_TOL,
                                   atol=POOL_TOL, err_msg=f"{name} pool {k}")


def test_instance_norm_ranks_equal_the_one_device_step(ranks):
    """pix2pix with instance norm: the 2 ranks' step is the one-device step
    on the global batch (per-sample norms, the losses batch means)."""
    from biasgan_tpu_torch.models.pix2pix import create_state, make_train_step

    name = "p2p_instance_lsgan"
    cfg = parse_config(CASES[name] + ["--device", "cpu"], train=True)
    cfg.steps_per_epoch = 2
    state = create_state(cfg, torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in _batch(CASES[name]).items()}
    losses, _ = make_train_step(cfg, debug_grad_norms=True)(state, batch, step_generator(0, 0))
    got = ranks[name]
    for k, v in losses.items():
        np.testing.assert_allclose(got["losses"][0][k], float(v), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=f"loss {k}")
    for opt, o in state.opts.items():
        want = _mu_by_net({k: t.numpy() for k, t in o.mu.items()})
        port = _mu_by_net(got["mu"][opt])
        for net in want:
            _close(port[net], want[net], 1e-3, 1e-3, f"Adam mu {net}")
    for net, v in state.nets.items():
        for k, t in v.state_dict().items():
            np.testing.assert_allclose(got["nets"][net][k], t.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{net}.{k}")


def test_ranks_draw_their_own_dropout_and_a_seed_repeats(ranks):
    """pix2pix with dropout (a resnet G's blocks), two steps, the two
    ranks given the same samples: their fakes differ, since each rank
    draws its own masks (``rank_generator``, as JAX folds the data index
    into its key); without dropout they are bitwise equal; and the same
    seeded run again gives the same losses and state, bitwise."""
    drop, again, plain = (ranks[k] for k in DRAWS)
    for got in (drop, again, plain):
        assert got["params_equal"]
    assert not np.array_equal(*drop["fakes"])
    np.testing.assert_array_equal(*plain["fakes"])
    assert drop["losses"] == again["losses"]
    for net, sd in drop["nets"].items():
        for k, v in sd.items():
            np.testing.assert_array_equal(again["nets"][net][k], v, err_msg=f"{net}.{k}")
    np.testing.assert_array_equal(drop["fakes"][0], again["fakes"][0])
