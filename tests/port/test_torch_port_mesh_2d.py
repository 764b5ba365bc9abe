"""The 2-D (data x spatial) mesh in the port, on the CPU: four spawned gloo
ranks as a 2 x 2 mesh (``parallel.mesh.mesh_groups``; one spawn carries the
layout checks and both models' steps), and ``python -m
biasgan_tpu_torch.train --data_mesh 2 --spatial_mesh 2``.

Layout: world rank r is (d, s) = divmod(r, 2), row-major as JAX
``make_mesh(2, 2)``; the rows are the spatial groups, the columns the data
groups. Each row's halo exchange, on its own field, is bitwise each
shard's window of the whole-W pad of that field (the ring's peers are the
row's world ranks), and ``same_on_every_rank`` and ``gather_w`` work on
row 1, which does not hold world rank 0.

Steps (ports of tests/distributed/test_spatial_train.py:109 and
tests/distributed/test_mesh_2d.py): pix2pix (unet_d4, basic D, batch norm,
vanilla, wrap W) and CycleGAN (resnet_3blocks, instance norm, lsgan, pool
4, zero W), ngf / ndf 8, 64x64, global batch 2 (one sample a data row),
dropout and augmentation off, one step, from the same weights (the port's
seeded nets, converted for JAX), against the JAX step under
``spatial_train_step`` on ``make_mesh(2, 2)`` with axes ("data",
"spatial"): batch statistics per data row, W-global within it; the grads,
losses and running averages averaged over all four ranks; CycleGAN's
pools gathered over the data column and sharded on W. Held by the bounds
of test_torch_port_spatial_pix2pix.py: losses 5e-4, parameters and running
averages atol 1.5e-3, fakes and pools 5e-4, every rank's state bitwise
rank 0's (the pools every data rank's).

The CLI: ``--data_mesh 2 --spatial_mesh 2`` equals ``--data_mesh 2`` with
batch norm and dropout on (a resnet G), two steps: the batch statistics
are per data rank in both, each data rank draws its own masks from its
data index, and a row draws the whole-W mask and keeps its columns.
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
from biasgan_tpu.models import cyclegan as jcg
from biasgan_tpu.models import pix2pix as jp2p
from biasgan_tpu.models.common import adam_transform_of, init_state
from biasgan_tpu.parallel import make_mesh
from biasgan_tpu.parallel.spatial import HaloCtx as JaxHaloCtx
from biasgan_tpu.parallel.spatial import shard_batch_spatial, spatial_train_step
from biasgan_tpu.utils.image_pool import create_pool
from biasgan_tpu_torch import train
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.parallel import spawn
from biasgan_tpu_torch.parallel.checks import mesh_checks
from biasgan_tpu_torch.registry import get_model

D, S, B, HW = 2, 2, 2, 64
LOSS_TOL, PARAM_ATOL, FAKE_TOL = 5e-4, 1.5e-3, 5e-4
SPAWN_TIMEOUT_S = 300
PADS = [(1, 1, True), (2, 1, False), (3, 0, True)]
COMMON = ["--dataset_mode", "synthetic", "--netD", "basic", "--crop_size", str(HW),
          "--input_nc", "1", "--output_nc", "1", "--batch_size", str(B), "--ngf", "8",
          "--ndf", "8", "--no_dropout", "--no-in_graph_aug", "--n_epochs", "1",
          "--n_epochs_decay", "1", "--data_mesh", str(D), "--spatial_mesh", str(S)]
MODELS = {
    "pix2pix": ["--model", "pix2pix", "--netG", "unet_d4", "--norm", "batch",
                "--gan_mode", "vanilla", "--w_pad_mode", "wrap"],
    "cycle_gan": ["--model", "cycle_gan", "--netG", "resnet_3blocks", "--norm", "instance",
                  "--gan_mode", "lsgan", "--pool_size", "4", "--w_pad_mode", "zero"],
}


def _field():
    """A global NHWC field per data row."""
    return np.random.default_rng(5).normal(size=(D, 1, 3, 8, 2)).astype(np.float32)


def _batch():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(B, HW, HW, 1)).astype(np.float32)
    return {"A": a, "B": np.tanh(1.3 * a + 0.2).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks():
    cases = [{"flags": MODELS[m], "steps": 1, "state": True, "fakes": True} for m in MODELS]
    layout, steps = spawn(mesh_checks, D * S, ((D, _field(), PADS),
                                               (COMMON + ["--device", "cpu"], cases, None,
                                                [_batch()])),
                          timeout=SPAWN_TIMEOUT_S, group_timeout=SPAWN_TIMEOUT_S)
    return layout, dict(zip(MODELS, steps))


def test_mesh_groups_layout(ranks):
    layout, _ = ranks
    for r, got in enumerate(layout):
        d, s = divmod(r, S)
        assert tuple(got["ds"]) == (d, s)
        assert got["row"] == [d * S + j for j in range(S)]
        assert got["column"] == [i * S + s for i in range(D)]


@pytest.mark.parametrize("pad", PADS)
def test_row_halo_exchange_is_the_whole_w_pad(ranks, pad):
    layout, _ = ranks
    left, right, periodic = pad
    x = _field()
    for r, got in enumerate(layout):
        d, s = divmod(r, S)
        if s:
            assert got["pads"][pad] is None
            continue
        whole = np.pad(x[d], ((0, 0), (0, 0), (left, right), (0, 0)),
                       mode="wrap" if periodic else "constant")
        wl = x.shape[3] // S  # each shard's padded columns, side by side
        want = np.concatenate([whole[:, :, j * wl:(j + 1) * wl + left + right]
                               for j in range(S)], axis=2)
        np.testing.assert_array_equal(got["pads"][pad], want, err_msg=f"row {d}")


def test_same_and_gather_on_a_row_without_world_rank_0(ranks):
    layout, _ = ranks
    x = _field()
    for r, got in enumerate(layout):
        d, s = divmod(r, S)
        assert got["same"] is True and got["differs"] is False, f"rank {r}"
        if s:
            assert got["gathered"] is None
        else:
            np.testing.assert_array_equal(got["gathered"], x[d], err_msg=f"row {d}")


def _jax_run(model, tmp_path):
    """The JAX step on make_mesh(2, 2) from the port's seeded nets:
    (losses, nets as port state dicts, pools, fake_B)."""
    argv = COMMON + MODELS[model]
    cfg = parse_config(argv + ["--device", "cpu"], train=True)
    jcfg = jax_parse_config(argv + ["--checkpoints_dir", str(tmp_path), "--name", "j"],
                            train=True)
    jcfg.steps_per_epoch = cfg.steps_per_epoch = 1
    state = get_model(model).create_state(cfg, torch.device("cpu"))
    nets, params = {}, {}
    for name, net in state.nets.items():
        p, stats = jax.tree_util.tree_map(jnp.asarray, state_dict_to_params(
            {k: v for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}))
        nets[name] = {"params": p, **({"batch_stats": stats} if stats else {})}
        params[name] = p
    tx = adam_transform_of(jcfg)
    ctx = JaxHaloCtx("spatial", S, periodic=jcfg.w_pad_mode == "wrap")
    if model == "pix2pix":
        jstate = init_state(nets, {k: (tx, params[k]) for k in ("G", "D")})
        fn = jp2p.make_train_step(jcfg, ("data", "spatial"), debug_grad_norms=True, ctx=ctx)
    else:
        jstate = init_state(
            nets, {"G": (tx, {k: params[k] for k in ("G_A", "G_B")}),
                   "D": (tx, {k: params[k] for k in ("D_A", "D_B")})},
            pools={k: create_pool(cfg.pool_size, (HW, HW, 1)) for k in ("fake_B", "fake_A")})
        fn = jcg.make_train_step(jcfg, ("data", "spatial"), ctx=ctx)
    mesh = make_mesh(data=D, spatial=S)
    step = jax.jit(spatial_train_step(fn, mesh, jcfg))
    batch = shard_batch_spatial({k: jnp.asarray(v) for k, v in _batch().items()}, mesh)
    jstate, losses, vis = step(jstate, batch, jax.random.PRNGKey(6))
    sds = {k: {name: t.numpy() for name, t in params_to_state_dict(
        v["params"], v.get("batch_stats")).items() if not name.endswith("num_batches_tracked")}
        for k, v in jstate.nets.items()}
    pools = {k: np.asarray(p.buffer) for k, p in jstate.pools.items()}
    return {k: float(v) for k, v in losses.items()}, sds, pools, np.asarray(vis["fake_B"])


@pytest.mark.parametrize("model", list(MODELS))
def test_2x2_step_matches_jax(ranks, model, tmp_path):
    got = ranks[1][model]
    wl, wnets, wpools, wfake = _jax_run(model, tmp_path)
    assert got["params_equal"], "the ranks' state differs"
    assert all(v == 0 for counts in got["launches"] for v in counts.values())
    (losses,) = got["losses"]
    assert sorted(losses) == sorted(wl)
    for k, v in wl.items():
        assert abs(losses[k] - v) <= LOSS_TOL * (1 + abs(v)), f"loss {k}: {losses[k]} vs {v}"
    for net, sd in wnets.items():
        if model == "pix2pix":
            assert any(k.endswith("running_var") for k in sd)
        for name, v in sd.items():
            np.testing.assert_allclose(got["nets"][net][name], v, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{net}.{name}")
    assert sorted(got["pools"]) == sorted(wpools)
    for k, v in wpools.items():
        np.testing.assert_allclose(got["pools"][k], v, rtol=FAKE_TOL, atol=FAKE_TOL,
                                   err_msg=f"pool {k}")
    np.testing.assert_allclose(got["fakes"], wfake, rtol=FAKE_TOL, atol=FAKE_TOL,
                               err_msg="fake_B")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--netG", "resnet_3blocks",
    "--norm", "batch", "--no-no_dropout", "--ngf", "8", "--ndf", "8", "--crop_size", str(HW),
    "--input_nc", "1", "--output_nc", "1", "--batch_size", str(B), "--synthetic_samples", "4",
    "--print_freq", "2", "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq", "1",
    "--lr_policy", "step", "--w_pad_mode", "wrap", "--data_mesh", str(D), "--device", "cpu",
]
LOSS_LINE = re.compile(r"^\(epoch: (\d+), iters: (\d+), time: [0-9.]+, data: [0-9.]+\) (.*)$")


def _loss_lines(out):
    return [((int(m.group(1)), int(m.group(2))),
             {k: float(v) for k, v in re.findall(r"(\w+): ([-0-9.]+)", m.group(3))})
            for m in map(LOSS_LINE.match, out.splitlines()) if m]


def test_cli_2d_mesh_matches_data_mesh(tmp_path):
    outs = {}
    for name, extra in (("data", []), ("mesh", ["--spatial_mesh", str(S)])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(CLI + ["--checkpoints_dir", str(tmp_path), "--name", name] + extra)
        outs[name] = buf.getvalue()
    out = outs["mesh"]
    assert ("mesh: data 2 x spatial 2 (rank->(d, s)->device 0->(0, 0)->cpu, 1->(0, 1)->cpu, "
            "2->(1, 0)->cpu, 3->(1, 1)->cpu), backend gloo") in out
    assert "mesh: parameters bitwise equal on every rank: True" in out
    assert len(re.findall(r"^mesh: rank \d: the grads' all-reduce 4 calls", out, re.M)) == 4
    got, want = _loss_lines(out), _loss_lines(outs["data"])
    assert [k for k, _ in got] == [k for k, _ in want] == [(1, 2), (1, 4)]
    for (_, g), (_, w) in zip(got, want):
        for k in w:  # the lines print 3 decimals
            assert abs(g[k] - w[k]) <= LOSS_TOL * (1 + abs(w[k])) + 1e-3, (k, g[k], w[k])
    g, w = (torch.load(tmp_path / name / "ckpt" / "epoch_1.pt", weights_only=True)
            for name in ("mesh", "data"))
    assert g["step"] == w["step"] == 2 and g["meta"] == w["meta"]
    for net, sd in w["nets"].items():
        for name, v in sd.items():
            np.testing.assert_allclose(g["nets"][net][name].numpy(), v.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{net}.{name}")
