"""Spatially sharded pix2pix training in the port, on the CPU: the step of
``models/pix2pix.py`` under a ``HaloCtx`` on 2 and 4 spawned gloo ranks
(one spawn per rank count carries every case), and ``python -m
biasgan_tpu_torch.train --model pix2pix --spatial_mesh 2``.

Ports of tests/distributed/test_spatial_train.py:70 and :269: unet_d4 and
resnet_3blocks G, basic D, ngf / ndf 8, 64x64, batch 2, batch norm (its
moments W-global, its running averages moved by them), no augmentation,
one step from the same weights: the port's seeded nets, converted for JAX
(the JAX package's own init takes 14-20 s a net on an 8-core CPU; both
sides start from the same weights either way). Dropout off, each rank count's
cases against the JAX ``spatial_train_step(make_train_step(cfg, "spatial",
ctx=HaloCtx(...)))`` on the conftest's virtual mesh: unet_d4, vanilla,
wrap W on two ranks; resnet_3blocks, wgangp (JAX's alpha,
``uniform(split(key)[1])``, handed to every rank), zero W on four (each
JAX case is a compile of ~6 s on a CPU, so each generator, GAN mode and W
mode runs once, on one of the two rank counts).
Dropout on (a resnet G: unet_d4 has no dropout layer), against the port's
one-device step from the same state and step generator: every rank of the
row draws the whole-W mask and keeps its columns, so it is the same
function.

Held: losses rtol/atol 5e-4 (the grad norms of the averaged grads among
them); parameters and running averages atol 1.5e-3 (JAX's ``PARAM_ATOL``:
Adam's first step moves each parameter by ~lr whatever its gradient); the
fakes, gathered over W, 5e-4; every rank's state bitwise rank 0's.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.models.common import adam_transform_of, init_state
from biasgan_tpu.models.pix2pix import make_train_step as jax_make_train_step
from biasgan_tpu.parallel import make_mesh
from biasgan_tpu.parallel.spatial import HaloCtx as JaxHaloCtx
from biasgan_tpu.parallel.spatial import shard_batch_spatial, spatial_train_step
from biasgan_tpu_torch import train
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.models.common import step_generator
from biasgan_tpu_torch.models.pix2pix import create_state, make_train_step
from biasgan_tpu_torch.parallel import spawn
from biasgan_tpu_torch.parallel.checks import train_cases

B, HW = 2, 64
ARGS = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--netD", "basic", "--norm", "batch",
    "--crop_size", str(HW), "--input_nc", "1", "--output_nc", "1", "--batch_size", str(B),
    "--ngf", "8", "--ndf", "8", "--no-in_graph_aug", "--n_epochs", "1", "--n_epochs_decay", "1",
]
LOSS_TOL, PARAM_ATOL, FAKE_TOL = 5e-4, 1.5e-3, 5e-4
SPAWN_TIMEOUT_S = 300
KEY = 4  # the JAX step key: jax.random.PRNGKey(KEY)
CASES = {
    2: [dict(g="unet_d4", gan="vanilla", w="wrap"),
        dict(g="resnet_3blocks", gan="lsgan", w="wrap", dropout=True)],
    4: [dict(g="resnet_3blocks", gan="wgangp", w="zero"),
        dict(g="resnet_3blocks", gan="vanilla", w="zero", dropout=True)],
}


def _flags(c):
    return ["--netG", c["g"], "--gan_mode", c["gan"], "--w_pad_mode", c["w"],
            "--no-no_dropout" if c.get("dropout") else "--no_dropout"]


def _batch():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(B, HW, HW, 1)).astype(np.float32)
    return {"A": a, "B": np.tanh(1.3 * a + 0.2).astype(np.float32)}


def _alpha():
    """The JAX spatial step's alpha: its key is not folded over W shards."""
    return np.asarray(jax.random.uniform(jax.random.split(jax.random.PRNGKey(KEY))[1],
                                         (B, 1, 1, 1)))


def _case(c):
    case = {"flags": _flags(c), "steps": 1, "state": True, "fakes": True}
    if c["gan"] == "wgangp":
        case["gp_alpha"] = [[_alpha()]]
    return case


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sharded(request):
    n = request.param
    res = spawn(train_cases, n, (ARGS + ["--device", "cpu"], [_case(c) for c in CASES[n]],
                                 None, [_batch()]),
                timeout=SPAWN_TIMEOUT_S, group_timeout=SPAWN_TIMEOUT_S)
    return n, res


def _cfg(c):
    cfg = parse_config(ARGS + _flags(c) + ["--device", "cpu"], train=True)
    cfg.steps_per_epoch = 1
    return cfg


def _jax_run(c, n, tmp_path):
    """The JAX sharded step on ``n`` virtual devices from the port's seeded
    nets: (losses, nets as port state dicts, the fakes)."""
    argv = ARGS + _flags(c) + ["--checkpoints_dir", str(tmp_path), "--name", "j"]
    jcfg = jax_parse_config(argv, train=True)
    jcfg.steps_per_epoch = 1
    state = create_state(_cfg(c), torch.device("cpu"))
    nets, opt_map = {}, {}
    tx = adam_transform_of(jcfg)
    for name, net in state.nets.items():
        params, stats = jax.tree_util.tree_map(jnp.asarray, state_dict_to_params(
            {k: v for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}))
        nets[name] = {"params": params, "batch_stats": stats}
        opt_map[name] = (tx, params)
    mesh = make_mesh(data=1, spatial=n)
    ctx = JaxHaloCtx("spatial", n, periodic=c["w"] == "wrap")
    step = jax.jit(spatial_train_step(
        jax_make_train_step(jcfg, "spatial", debug_grad_norms=True, ctx=ctx), mesh))
    batch = shard_batch_spatial({k: jnp.asarray(v) for k, v in _batch().items()}, mesh)
    jstate, losses, vis = step(init_state(nets, opt_map), batch, jax.random.PRNGKey(KEY))
    sds = {k: {name: t.numpy() for name, t in params_to_state_dict(
        v["params"], v["batch_stats"]).items() if not name.endswith("num_batches_tracked")}
        for k, v in jstate.nets.items()}
    return ({k: float(v) for k, v in losses.items()}, sds, np.asarray(vis["fake_B"]))


def _one_device(c):
    """The port's one-device step from its seeded state (the ranks draw
    the same): (losses, nets, fakes)."""
    cfg = _cfg(c)
    state = create_state(cfg, torch.device("cpu"))
    losses, vis = make_train_step(cfg, debug_grad_norms=True)(
        state, {k: torch.from_numpy(v) for k, v in _batch().items()},
        step_generator(cfg.seed, 0))
    sds = {k: {name: t.detach().numpy() for name, t in v.state_dict().items()}
           for k, v in state.nets.items()}
    return {k: float(v) for k, v in losses.items()}, sds, vis["fake_B"].numpy()


def _hold(got, want, what):
    wl, wnets, wfake = want
    assert got["params_equal"], f"{what}: the ranks' state differs"
    assert all(v == 0 for counts in got["launches"] for v in counts.values())
    (losses,) = got["losses"]
    assert sorted(losses) == sorted(wl), what
    for k, v in wl.items():
        assert abs(losses[k] - v) <= LOSS_TOL * (1 + abs(v)), f"{what}: {k} {losses[k]} vs {v}"
    for net, sd in wnets.items():
        for name, v in sd.items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got["nets"][net][name], v, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{what}: {net}.{name}")
    np.testing.assert_allclose(got["fakes"], wfake, rtol=FAKE_TOL, atol=FAKE_TOL,
                               err_msg=f"{what}: fake_B")


@pytest.mark.parametrize("case", range(2))
def test_sharded_pix2pix_step(sharded, case, tmp_path):
    """Dropout off: the JAX sharded step; dropout on: the port's one-device
    step (module docstring)."""
    n, res = sharded
    c = CASES[n][case]
    if c.get("dropout"):
        _hold(res[case], _one_device(c), f"{n} ranks {c} vs one device")
        # and the masks dropped something: the step without dropout differs
        plain = _one_device({**c, "dropout": False})
        assert abs(plain[0]["G_L1"] - res[case]["losses"][0]["G_L1"]) > 1e-3
    else:
        _hold(res[case], _jax_run(c, n, tmp_path), f"{n} ranks {c} vs JAX")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--netG", "unet_d4", "--ngf", "8",
    "--ndf", "8", "--crop_size", str(HW), "--input_nc", "1", "--output_nc", "1",
    "--batch_size", str(B), "--synthetic_samples", "6", "--val_split", "2", "--val_freq", "2",
    "--aug_lon_roll", "--print_freq", "2",
    "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq", "1", "--lr_policy", "step",
    "--w_pad_mode", "wrap", "--device", "cpu",
]
LOSS_LINE = re.compile(r"^\(epoch: (\d+), iters: (\d+), time: [0-9.]+, data: [0-9.]+\) (.*)$")
METRICS = re.compile(r"^validation \((train batch|held out)\): rmse: (\S+) bias: (\S+) "
                     r"pdf_tv: (\S+) log_spectral_distance: (\S+)$", re.M)


def _loss_lines(out):
    return [((int(m.group(1)), int(m.group(2))),
             {k: float(v) for k, v in re.findall(r"(\w+): ([-0-9.]+)", m.group(3))})
            for m in map(LOSS_LINE.match, out.splitlines()) if m]


def test_cli_sharded_pix2pix_matches_one_device(tmp_path):
    """Batch norm, the flip and roll augmentation on the global batch, two
    steps, a held-out batch and a validation point after each step: the
    loss lines, the validation lines (the W shards gathered; the held-out
    forward on the sharded batch) and the saved state of --spatial_mesh 2
    are the one-device run's."""
    outs = {}
    for name, extra in (("one", []), ("sharded", ["--spatial_mesh", "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(CLI + ["--checkpoints_dir", str(tmp_path), "--name", name] + extra)
        outs[name] = buf.getvalue()
    out = outs["sharded"]
    assert "spatial: 2 rank(s) (rank->device 0->cpu, 1->cpu), backend gloo" in out
    assert "spatial: parameters bitwise equal on every rank: True" in out
    got, want = _loss_lines(out), _loss_lines(outs["one"])
    assert [k for k, _ in got] == [k for k, _ in want] == [(1, 2), (1, 4)]
    for (_, g), (_, w) in zip(got, want):
        for k in w:  # the lines print 3 decimals
            assert abs(g[k] - w[k]) <= LOSS_TOL * (1 + abs(w[k])) + 1e-3, (k, g[k], w[k])
    want, got = METRICS.findall(outs["one"]), METRICS.findall(out)
    assert [m[0] for m in got] == [m[0] for m in want] == ["train batch", "held out"] * 2
    for w, g in zip(want, got):  # 4 decimals; a fake near a bin edge may move a count
        for a, b, tol in zip(w[1:], g[1:], (2e-4, 2e-4, 0.01, 2e-4)):
            assert abs(float(a) - float(b)) <= tol, (w, g)
    g, w = (torch.load(tmp_path / name / "ckpt" / "epoch_1.pt", weights_only=True)
            for name in ("sharded", "one"))
    assert g["step"] == w["step"] == 2 and g["meta"] == w["meta"]
    for net, sd in w["nets"].items():
        assert any(k.endswith("running_mean") for k in sd)
        for name, v in sd.items():
            np.testing.assert_allclose(g["nets"][net][name].numpy(), v.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{net}.{name}")
