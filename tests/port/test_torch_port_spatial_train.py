"""Spatially sharded CycleGAN training in the port, on the CPU: the step of
``models/cyclegan.py`` under a ``HaloCtx`` on 2 and 4 spawned gloo ranks
(one spawn per rank count carries its cases), and ``python -m
biasgan_tpu_torch.train --spatial_mesh 2``.

Ports of tests/distributed/test_spatial_train.py:180 and :230 at the sizes
of the CycleGAN parity test: resnet_3blocks, ngf 8, ndf 8, 64x64 (at 32 the
Ds' last norms see 3x3 maps and their gradients are noise), batch 2, pool
4, the JAX package's initial weights. Two sharded steps with the pools,
fused (the block conv's halo W mode) and unfused, wrap and zero-edge W, and
with the flip and roll augmentation on, must equal the port's one-device
steps from the same weights, batches and step generators: losses rtol/atol
5e-4, parameters atol 1.5e-3 (Adam's first steps move each parameter by
~lr whatever its gradient, so rounding flips single elements by 2 lr),
pools 5e-4, and every rank's parameters bitwise equal. The unfused wrap
case on two ranks must also equal the JAX ``spatial_train_step`` on two
devices of the conftest's virtual mesh.

Step 2 starts from parameters that Adam's first step has already set by
the signs of the step-1 gradients, and at initialisation some of those
gradients are within rounding of zero: a 1e-6 relative move of the step-1
inputs moves the one-device step-2 fakes by ~3e-3. So what step 2 adds is
held to the bounds above plus NOISE_FACTOR times that movement of the
one-device run itself (the noise-floor rule of ``chip_smoke.py``): the
step-2 losses and the pool slots that step 2 fills. Step 1, and the pool
slots it fills, are held to the bounds alone.
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
from biasgan_tpu.models.cyclegan import create_state as jax_create_state
from biasgan_tpu.models.cyclegan import make_train_step as jax_make_train_step
from biasgan_tpu.parallel import make_mesh
from biasgan_tpu.parallel.spatial import HaloCtx as JaxHaloCtx
from biasgan_tpu.parallel.spatial import shard_batch_spatial, spatial_train_step
from biasgan_tpu_torch import train
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.convert import params_to_state_dict
from biasgan_tpu_torch.models.common import step_generator
from biasgan_tpu_torch.models.cyclegan import build_nets, create_state, make_train_step
from biasgan_tpu_torch.parallel import spawn
from biasgan_tpu_torch.parallel.checks import train_cases

ARGS = [
    "--model", "cycle_gan", "--dataset_mode", "synthetic", "--netG", "resnet_3blocks",
    "--netD", "basic", "--gan_mode", "lsgan", "--norm", "instance", "--no_dropout",
    "--crop_size", "64", "--input_nc", "1", "--output_nc", "1", "--batch_size", "2",
    "--ngf", "8", "--ndf", "8", "--pool_size", "4", "--no-in_graph_aug",
    "--n_epochs", "1", "--n_epochs_decay", "1",
]
B, HW, STEPS = 2, 64, 2
LOSS_TOL, PARAM_ATOL, POOL_TOL = 5e-4, 1.5e-3, 5e-4
NOISE_FACTOR, NOISE_INPUT = 3.0, 1e-6
SPAWN_TIMEOUT_S = 300


def _flags(c):
    return (["--w_pad_mode", c["w"]] + (["--fused_blocks"] if c["fused"] else [])
            + (["--in_graph_aug", "--aug_lon_roll"] if c.get("aug") else []))


CASES = {
    2: [dict(w="wrap", fused=False), dict(w="zero", fused=True),
        dict(w="wrap", fused=True, aug=True)],
    4: [dict(w="wrap", fused=True), dict(w="zero", fused=False),
        dict(w="zero", fused=False, aug=True)],
}


def _batches():
    rng = np.random.default_rng(1)
    return [{"A": rng.normal(size=(B, HW, HW, 1)).astype(np.float32),
             "B": np.tanh(rng.normal(size=(B, HW, HW, 1))).astype(np.float32)}
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_nets(tmp_path_factory):
    """The JAX package's initial weights, as the port's state dicts."""
    jcfg = jax_parse_config(ARGS + ["--w_pad_mode", "wrap", "--checkpoints_dir",
                                    str(tmp_path_factory.mktemp("jax")), "--name", "sp"],
                            train=True)
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0))
    return {k: {n: t.numpy().copy() for n, t in
                params_to_state_dict(jstate.nets[k]["params"]).items()}
            for k in ("G_A", "G_B", "D_A", "D_B")}


def _one_device(nets, flags, perturb=0.0):
    """The port's one-device steps: (each step's losses, the final state)."""
    cfg = parse_config(ARGS + flags + ["--device", "cpu"], train=True)
    cfg.steps_per_epoch = STEPS
    built = build_nets(cfg)
    for name, net in built.items():
        net.load_state_dict({k: torch.from_numpy(v) for k, v in nets[name].items()})
    state = create_state(cfg, torch.device("cpu"), built)
    step = make_train_step(cfg)
    losses = []
    for i, b in enumerate(_batches()):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        if perturb and i == 0:
            g = torch.Generator().manual_seed(11)
            batch = {k: v * (1 + perturb * torch.randn(v.shape, generator=g))
                     for k, v in batch.items()}
        ls, _ = step(state, batch, step_generator(cfg.seed, i))
        losses.append({k: float(v) for k, v in ls.items()})
    pools = {k: p.buffer.numpy() for k, p in state.pools.items()}
    params = {k: {n: t.detach().numpy() for n, t in v.state_dict().items()}
              for k, v in state.nets.items()}
    return losses, params, pools


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sharded(request, jax_nets):
    n = request.param
    cases = [dict(flags=_flags(c), steps=STEPS) for c in CASES[n]]
    res = spawn(train_cases, n, (ARGS + ["--device", "cpu"], cases, jax_nets, _batches()),
                timeout=SPAWN_TIMEOUT_S, group_timeout=SPAWN_TIMEOUT_S)
    return n, res


def _hold(got_losses, got_params, got_pools, ref, moved, what):
    """``got`` against the reference run ``ref``, with step 2's share of
    the bounds widened by NOISE_FACTOR x how far ``moved`` (the reference
    on inputs moved by NOISE_INPUT) is from it (module docstring)."""
    (rl, rp, rpool), (ml, _, mpool) = ref, moved
    for i, (g, r, m) in enumerate(zip(got_losses, rl, ml)):
        for k in r:
            noise = NOISE_FACTOR * abs(m[k] - r[k]) if i else 0.0
            assert abs(g[k] - r[k]) <= LOSS_TOL * (1 + abs(r[k])) + noise, (
                f"{what}: step {i + 1} loss {k}: {g[k]} vs {r[k]} (noise {noise:.3g})")
    for net, sd in rp.items():
        for name, v in sd.items():
            np.testing.assert_allclose(got_params[net][name], v, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{what}: {net}.{name}")
    for k, r in rpool.items():
        g = got_pools[k]
        assert g.shape == r.shape
        np.testing.assert_allclose(g[:B], r[:B], rtol=POOL_TOL, atol=POOL_TOL,
                                   err_msg=f"{what}: pool {k}, step-1 slots")
        noise = NOISE_FACTOR * float(np.abs(mpool[k][B:] - r[B:]).max())
        np.testing.assert_allclose(g[B:], r[B:], rtol=POOL_TOL, atol=POOL_TOL + noise,
                                   err_msg=f"{what}: pool {k}, step-2 slots (noise {noise:.3g})")


@pytest.mark.parametrize("case", range(3))
def test_sharded_steps_match_one_device(sharded, jax_nets, case):
    n, res = sharded
    c, got = CASES[n][case], res[case]
    assert got["params_equal"], "the ranks' parameters differ"
    assert len(got["losses"]) == STEPS
    flags = _flags(c)
    ref = _one_device(jax_nets, flags)
    moved = _one_device(jax_nets, flags, NOISE_INPUT)
    _hold(got["losses"], got["nets"], got["pools"], ref, moved, f"{n} ranks {c}")


def test_sharded_ranks_launch_no_kernel_on_the_cpu(sharded):
    n, res = sharded
    for got in res:
        assert len(got["launches"]) == n
        assert all(v == 0 for counts in got["launches"] for v in counts.values())


@pytest.mark.parametrize("sharded", [2], indirect=True, ids=["2ranks"])
def test_unfused_sharded_steps_match_jax_spatial_train_step(sharded, jax_nets, tmp_path):
    """The unfused wrap case on two ranks against the JAX step under
    ``spatial_train_step`` on two devices (the pools only fill in two
    steps of batch 2, so no random draw enters)."""
    n, res = sharded
    flags = _flags(CASES[2][0])
    jcfg = jax_parse_config(ARGS + flags + ["--checkpoints_dir", str(tmp_path), "--name", "j"],
                            train=True)
    jcfg.in_graph_aug = False
    jcfg.steps_per_epoch = STEPS
    mesh = make_mesh(data=1, spatial=2)
    step = jax.jit(spatial_train_step(
        jax_make_train_step(jcfg, "spatial", ctx=JaxHaloCtx("spatial", 2, periodic=True)),
        mesh, jcfg))
    state = jax_create_state(jcfg, jax.random.PRNGKey(0))
    losses = []
    for i, b in enumerate(_batches()):
        batch = shard_batch_spatial({k: jnp.asarray(v) for k, v in b.items()}, mesh)
        state, ls, _ = step(state, batch, jax.random.PRNGKey(20 + i))
        losses.append({k: float(v) for k, v in ls.items()})
    params = {k: {name: t.numpy() for name, t in
                  params_to_state_dict(state.nets[k]["params"]).items()}
              for k in ("G_A", "G_B", "D_A", "D_B")}
    pools = {k: np.asarray(p.buffer) for k, p in state.pools.items()}
    moved = _one_device(jax_nets, flags, NOISE_INPUT)
    got = res[0]
    _hold(got["losses"], got["nets"], got["pools"], (losses, params, pools), moved,
          "against the JAX spatial step")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = [
    "--model", "cycle_gan", "--dataset_mode", "synthetic", "--netG", "resnet_3blocks",
    "--ngf", "8", "--ndf", "8", "--crop_size", "64", "--input_nc", "1", "--output_nc", "1",
    "--batch_size", "2", "--synthetic_samples", "2", "--pool_size", "4",
    "--print_freq", "2", "--n_epochs", "1", "--n_epochs_decay", "1",
    "--save_epoch_freq", "1", "--lr_policy", "step", "--fused_blocks", "--device", "cpu",
]
LOSS_LINE = re.compile(r"^\(epoch: (\d+), iters: (\d+), time: [0-9.]+, data: [0-9.]+\) (.*)$")


def _loss_lines(out):
    lines = []
    for ln in out.splitlines():
        m = LOSS_LINE.match(ln)
        if m:
            vals = {k: float(v) for k, v in re.findall(r"(\w+): ([-0-9.]+)", m.group(3))}
            lines.append(((int(m.group(1)), int(m.group(2))), vals))
    return lines


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One device, and --spatial_mesh 2 (with --halo_rdma, which training
    ignores), the same command line otherwise: their stdout."""
    ckpt = tmp_path_factory.mktemp("train_spatial")
    outs = {}
    for name, extra in (("one", []), ("sharded", ["--spatial_mesh", "2", "--halo_rdma"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = train.main(CLI + ["--w_pad_mode", "wrap", "--checkpoints_dir", str(ckpt),
                                       "--name", name] + extra)
        outs[name] = (buf.getvalue(), result)
    return ckpt, outs


def _load(ckpt, name, tag):
    return torch.load(ckpt / name / "ckpt" / f"{tag}.pt", weights_only=True)


def test_cli_sharded_matches_one_device(cli_runs):
    ckpt, outs = cli_runs
    out, result = outs["sharded"]
    assert "spatial: 2 rank(s) (rank->device 0->cpu, 1->cpu), backend gloo" in out
    assert "--fused_blocks: fused training path engaged (conv3x3_fused_t in its halo W" in out
    assert "--halo_rdma: ignored in training" in out
    assert "spatial: parameters bitwise equal on every rank: True" in out
    assert result["params_equal"] and len(result["launches"]) == 2
    got, want = _loss_lines(out), _loss_lines(outs["one"][0])
    assert [k for k, _ in got] == [k for k, _ in want] == [(1, 2), (2, 4)]
    for (_, g), (_, w) in zip(got, want):
        for k in w:  # the lines print 3 decimals
            assert abs(g[k] - w[k]) <= LOSS_TOL * (1 + abs(w[k])) + 1e-3, (k, g[k], w[k])
    with open(ckpt / "sharded" / "loss_log.txt") as f:
        assert len([ln for ln in f if LOSS_LINE.match(ln)]) == 2
    for tag in ("epoch_1", "epoch_2"):
        g, w = _load(ckpt, "sharded", tag), _load(ckpt, "one", tag)
        assert g["step"] == w["step"] and g["meta"] == w["meta"]
        for net, sd in w["nets"].items():
            for name, v in sd.items():
                np.testing.assert_allclose(g["nets"][net][name].numpy(), v.numpy(), rtol=0,
                                           atol=PARAM_ATOL, err_msg=f"{tag} {net}.{name}")
        for k, p in w["pools"].items():
            assert g["pools"][k]["count"] == p["count"]
            assert g["pools"][k]["buffer"].shape == p["buffer"].shape == (4, HW, HW, 1)
            # the slots step 1 filled; step 2's are held by the step tests
            np.testing.assert_allclose(g["pools"][k]["buffer"][:B].numpy(),
                                       p["buffer"][:B].numpy(), rtol=POOL_TOL, atol=POOL_TOL)


def test_cli_sharded_resume_is_bit_exact(cli_runs, tmp_path):
    """Resume epoch 2 of the sharded run from its epoch-1 state (the pools
    re-sharded from the gathered checkpoint): the same state, tensor for
    tensor, as the uninterrupted sharded run."""
    import shutil

    ckpt, _ = cli_runs
    shutil.copytree(ckpt / "sharded", tmp_path / "resumed")
    for f in (tmp_path / "resumed" / "ckpt").iterdir():
        if not f.name.startswith("epoch_1"):
            f.unlink()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(CLI + ["--w_pad_mode", "wrap", "--checkpoints_dir", str(tmp_path),
                          "--name", "resumed", "--spatial_mesh", "2", "--continue_train",
                          "--epoch", "epoch_1", "--epoch_count", "2"])
    assert "resumed training state 'epoch_1' at step 1" in buf.getvalue()
    want = _load(ckpt, "sharded", "epoch_2")
    got = torch.load(tmp_path / "resumed" / "ckpt" / "epoch_2.pt", weights_only=True)

    def same(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), where
        else:
            assert a == b, where

    same(got, want, "state")


def test_cli_spatial_mesh_refuses_reflect_and_pix2pix(tmp_path):
    """The refusals that stand are the JAX package's: a reflecting W (a
    resnet's default) and pix2pix's wgangp with the pixel D; pix2pix
    itself now trains sharded (held to one device in
    test_torch_port_spatial_pix2pix.py)."""
    with pytest.raises(ValueError, match="--w_pad_mode"):
        train.main(CLI + ["--checkpoints_dir", str(tmp_path), "--name", "r",
                          "--spatial_mesh", "2"])
    p2p = ["--model", "pix2pix", "--dataset_mode", "synthetic", "--netG", "unet_d4",
           "--ngf", "8", "--ndf", "8", "--crop_size", "32", "--input_nc", "1",
           "--output_nc", "1", "--batch_size", "2", "--synthetic_samples", "2",
           "--n_epochs", "1", "--n_epochs_decay", "0", "--spatial_mesh", "2",
           "--device", "cpu", "--checkpoints_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="wgangp and --netD pixel"):
        train.main(p2p + ["--gan_mode", "wgangp", "--netD", "pixel", "--name", "gp"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = train.main(p2p + ["--name", "p"])  # the U-Net pads W with zeros
    assert result["params_equal"]
    assert "spatial: parameters bitwise equal on every rank: True" in out.getvalue()
