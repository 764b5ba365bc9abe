"""K steps a call (--steps_per_call) in the port, on the CPU:
``models.common.make_scan_step`` against the JAX ``make_scan_step``
(tests/distributed/test_scan_step.py) on one device, under --data_mesh 2
(two spawned gloo ranks) against ``data_parallel_step(..., batch_axis=1)``
and under --spatial_mesh 2 against ``spatial_train_step(scan_k=2)`` on the
conftest's virtual devices; and the port's K-step call against K single
steps of the port, bitwise.

Against JAX, the configurations of test_scan_step.py: pix2pix, unet_d4 G
(resnet_3blocks on the spatial mesh, whose W must split over the shards of
its two downs), basic D, ngf / ndf 8, 32x32, 1 channel, dropout off, no
augmentation, pool 0, lsgan; instance norm on one device (test_scan_step's)
and batch norm on the meshes (its running averages, W-global moments on
the spatial mesh). Both packages start from the same weights, the port's
seeded nets converted; the draws do not enter (no dropout, augmentation,
penalty or pool). K = 3 on one device, 2 on the meshes. Held at the
tolerances of test_torch_port_pix2pix.py:12-27: each step's losses at rtol
2e-4; the running averages at rtol 1e-3 and 1e-4 of the tree's largest
|value|; the parameters within 2 K lr everywhere and within rtol 1e-3 and
1e-5 of the tree's largest |value| at all but 0.5% of each leaf's elements
(under instance norm the biases ahead of a norm, all rounding noise,
within 2 K lr only). The losses have shape (K,), the step count is K, the
visuals are the last step's, every rank's state bitwise rank 0's.

Against K single steps (dropout on, --in_graph_aug with the longitude
roll, CycleGAN's pool 16 with its draws): losses, parameters, running
averages, Adam moments and pools bitwise equal, and the pools hold K * B
fakes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.models.common import make_scan_step as jax_make_scan_step
from biasgan_tpu.models.common import stack_batches as jax_stack_batches
from biasgan_tpu.models.pix2pix import make_train_step as jax_make_train_step
from biasgan_tpu.parallel import data_parallel_step, make_mesh, shard_batch
from biasgan_tpu.parallel.spatial import HaloCtx as JaxHaloCtx
from biasgan_tpu.parallel.spatial import shard_batch_spatial, spatial_train_step
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.models.common import make_scan_step, stack_batches, step_generator
from biasgan_tpu_torch.parallel import spawn
from biasgan_tpu_torch.parallel.checks import train_cases
from biasgan_tpu_torch.registry import get_model
from test_torch_port_pix2pix import NORMED_BIASES, _sd, jax_state_of

S, LR = 32, 2e-4
LOSS_RTOL = 2e-4
SPAWN_TIMEOUT_S = 300
ARGS = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--netD", "basic",
    "--crop_size", str(S), "--input_nc", "1", "--output_nc", "1", "--ngf", "8", "--ndf", "8",
    "--no_dropout", "--no-in_graph_aug", "--gan_mode", "lsgan", "--pool_size", "0",
    "--lr", str(LR), "--n_epochs", "1", "--n_epochs_decay", "1",
]
ONE = ARGS + ["--netG", "unet_d4", "--norm", "instance", "--batch_size", "2"]
MESH = {
    "data": ARGS + ["--netG", "unet_d4", "--norm", "batch", "--batch_size", "4",
                    "--data_mesh", "2", "--steps_per_call", "2"],
    "spatial": ARGS + ["--netG", "resnet_3blocks", "--norm", "batch", "--batch_size", "4",
                       "--w_pad_mode", "wrap", "--spatial_mesh", "2", "--steps_per_call", "2"],
}
KEY = 7  # the JAX call's key


def _batches(k, b, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        a = rng.normal(size=(b, S, S, 1)).astype(np.float32)
        out.append({"A": a, "B": np.tanh(1.3 * a + 0.2).astype(np.float32)})
    return out


def _cfgs(argv, tmp_path):
    jcfg = jax_parse_config(argv + ["--checkpoints_dir", str(tmp_path), "--name", "j"],
                            train=True)
    cfg = parse_config(argv + ["--device", "cpu"], train=True)
    jcfg.steps_per_epoch = cfg.steps_per_epoch = 8
    return jcfg, cfg


def _hold_nets(got, jnets, steps, what, noise=NORMED_BIASES, instance=False):
    """The port's nets (name -> state dict of numpy) against the JAX
    state's, by the rules of the module docstring."""
    for net, v in jnets.items():
        want = _sd(v["params"], v.get("batch_stats"))
        have = {k: t for k, t in got[net].items() if not k.endswith("num_batches_tracked")}
        assert sorted(have) == sorted(want), f"{what} {net}"
        stats = [k for k in want if "running" in k]
        if stats:
            atol = 1e-4 * max(float(np.abs(want[k]).max()) for k in stats)
            for k in stats:
                np.testing.assert_allclose(have[k], want[k], rtol=1e-3, atol=atol,
                                           err_msg=f"{what} {net}.{k}")
        params = [k for k in want if k not in stats]
        atol = 1e-5 * max(float(np.abs(want[k]).max()) for k in params)
        skip = noise.get(net, ()) if instance else ()
        for k in params:
            d = np.abs(have[k] - want[k])
            assert d.max() <= 2 * steps * LR, f"{what} {net}.{k}: {d.max()}"
            off = float(np.mean(d > 1e-3 * np.abs(want[k]) + atol))
            assert k in skip or off <= 0.005, f"{what} {net}.{k}: {off:.2%} off"


def _hold_losses(got, want, what):
    """Per step: the port's losses (a list of dicts) against JAX's (K,)."""
    for name, v in want.items():
        v = np.asarray(v)
        assert v.shape == (len(got),), (what, name, v.shape)
        for i, ls in enumerate(got):
            np.testing.assert_allclose(ls[name], float(v[i]), rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=f"{what} step {i + 1} loss {name}")


def test_scan_matches_jax_make_scan_step(tmp_path):
    k = 3
    jcfg, cfg = _cfgs(ONE, tmp_path)
    state = get_model("pix2pix").create_state(cfg, torch.device("cpu"))
    jstate = jax_state_of(state, jcfg)
    batches = _batches(k, 2)
    jscan = jax.jit(jax_make_scan_step(jax_make_train_step(jcfg), k))
    jstacked = {n: jnp.asarray(v) for n, v in jax_stack_batches(batches).items()}
    jstate, jl, jvis = jscan(jstate, jstacked, jax.random.PRNGKey(KEY))

    call = make_scan_step(get_model("pix2pix").make_train_step(cfg), k, cfg.seed)
    stacked = {n: torch.from_numpy(v) for n, v in stack_batches(batches).items()}
    losses, vis = call(state, stacked, 0)
    assert state.step == int(jstate.step) == k
    assert sorted(losses) == sorted(jl)
    for name, v in losses.items():
        assert v.shape == (k,) and v.dtype == torch.float32
    _hold_losses([{n: float(v[i]) for n, v in losses.items()} for i in range(k)], jl, "one")
    _hold_nets({net: {n: t.numpy() for n, t in m.state_dict().items()}
                for net, m in state.nets.items()}, jstate.nets, k, "one", instance=True)
    # the visuals are the last step's: its batch, and a fake of its shape
    np.testing.assert_array_equal(vis["real_A"].numpy(), batches[-1]["A"])
    assert vis["fake_B"].shape == jvis["fake_B"].shape == (2, S, S, 1)


@pytest.fixture(scope="module")
def ranks():
    """Both mesh cases on 2 gloo ranks, in one spawn, each from the port's
    seeded state: one call of 2 steps on two global batches."""
    cases = [{"flags": MESH[name][len(ARGS):], "steps": 2, "state": True}
             for name in MESH]
    res = spawn(train_cases, 2, (ARGS + ["--device", "cpu"], cases, None, _batches(2, 4)),
                timeout=SPAWN_TIMEOUT_S, group_timeout=SPAWN_TIMEOUT_S)
    return dict(zip(MESH, res))


def _jax_mesh_run(name, jcfg, cfg):
    state = get_model("pix2pix").create_state(cfg, torch.device("cpu"))
    jstate = jax_state_of(state, jcfg)
    stacked = {n: jnp.asarray(v) for n, v in jax_stack_batches(_batches(2, 4)).items()}
    if name == "data":
        mesh = make_mesh(data=2)
        step = data_parallel_step(
            jax_make_scan_step(jax_make_train_step(jcfg, axis_name="data"), 2), mesh,
            batch_axis=1)
        stacked = shard_batch(stacked, mesh, batch_axis=1)
    else:
        mesh = make_mesh(data=1, spatial=2)
        ctx = JaxHaloCtx("spatial", 2, periodic=True)
        step = spatial_train_step(
            jax_make_scan_step(jax_make_train_step(jcfg, "spatial", ctx=ctx), 2), mesh, jcfg,
            scan_k=2)
        stacked = shard_batch_spatial(stacked, mesh, scan=True)
    return jax.jit(step)(jstate, stacked, jax.random.PRNGKey(KEY))


@pytest.mark.parametrize("name", list(MESH))
def test_scan_on_a_mesh_matches_jax(ranks, name, tmp_path):
    got = ranks[name]
    assert got["params_equal"], f"{name}: the ranks' state differs"
    assert got["step"] == 2 and len(got["losses"]) == 2
    jcfg, cfg = _cfgs(MESH[name], tmp_path)
    jstate, jl, _ = _jax_mesh_run(name, jcfg, cfg)
    assert int(jstate.step) == 2
    _hold_losses(got["losses"], jl, name)
    _hold_nets(got["nets"], jstate.nets, 2, name)


# ---------------------------------------------------------------------------
# the K-step call against K single steps of the port
# ---------------------------------------------------------------------------

DRAWN = {
    # the flags after ARGS override its own (the last of a flag counts)
    "pix2pix": ARGS + ["--netG", "resnet_3blocks", "--norm", "batch", "--batch_size", "2",
                       "--no-no_dropout", "--in_graph_aug", "--aug_lon_roll",
                       "--gan_mode", "vanilla"],
    "cycle_gan": ["--model", "cycle_gan", "--dataset_mode", "synthetic", "--netG",
                  "resnet_3blocks", "--netD", "basic", "--norm", "instance", "--no-no_dropout",
                  "--gan_mode", "lsgan", "--pool_size", "16", "--crop_size", str(S),
                  "--input_nc", "1", "--output_nc", "1", "--batch_size", "2", "--ngf", "8",
                  "--ndf", "8", "--in_graph_aug", "--aug_lon_roll", "--n_epochs", "1",
                  "--n_epochs_decay", "1"],
}


def _everything(state):
    """Every tensor of the state by name (nets, Adam moments, pools)."""
    out = {f"{n}/{k}": t for n, m in state.nets.items() for k, t in m.state_dict().items()}
    for n, o in state.opts.items():
        out.update({f"opt {n} mu {k}": t for k, t in o.mu.items()})
        out.update({f"opt {n} nu {k}": t for k, t in o.nu.items()})
    out.update({f"pool {n}": p.buffer for n, p in state.pools.items()})
    return out


@pytest.mark.parametrize("model", list(DRAWN))
def test_scan_is_k_single_steps_bitwise(model):
    k = 3
    cfg = parse_config(DRAWN[model] + ["--device", "cpu"], train=True)
    cfg.steps_per_epoch = 8
    entry = get_model(model)
    batches = _batches(k, 2, seed=5)
    states = [entry.create_state(cfg, torch.device("cpu")) for _ in range(2)]
    step = entry.make_train_step(cfg)
    singles = [step(states[0], {n: torch.from_numpy(v) for n, v in b.items()},
                    step_generator(cfg.seed, i))[0] for i, b in enumerate(batches)]
    stacked = {n: torch.from_numpy(v) for n, v in stack_batches(batches).items()}
    losses, _ = make_scan_step(entry.make_train_step(cfg), k, cfg.seed)(states[1], stacked, 0)
    for name, v in losses.items():
        assert v.shape == (k,)
        assert torch.equal(v, torch.stack([ls[name] for ls in singles])), name
    one, call = _everything(states[0]), _everything(states[1])
    assert sorted(one) == sorted(call)
    for name, t in one.items():
        assert torch.equal(t, call[name]), name
    assert states[0].step == states[1].step == k
    for p in states[1].pools.values():
        assert p.count == k * cfg.batch_size
    # the draws entered: the masks and flips of other steps change the run
    other = entry.create_state(cfg, torch.device("cpu"))
    moved, _ = make_scan_step(entry.make_train_step(cfg), k, cfg.seed)(other, stacked, 1)
    assert not all(torch.equal(moved[n], losses[n]) for n in losses)
