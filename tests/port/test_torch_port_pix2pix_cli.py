"""pix2pix through the PyTorch port's CLIs on the CPU.

Training (``biasgan_tpu_torch.train.main``, in this process): the tiny
drive of the JAX CLI's verification notes (unet_d4, 64x64, batch 4, ngf /
ndf 16, 16 synthetic samples, two epochs): the reference loss lines, G_L1
lower at the end than at the start, the state and per-net weights saved,
and a run resumed from the epoch-1 state bitwise equal to the
uninterrupted one at the end of epoch 2 (nets with their running
averages, Adam, step). With no --netG / --norm the CLI trains the
reference's default: unet_256, batch norm, dropout on. Kernel-route flags
with a U-Net say that they found no layer to take.

Serving: a U-Net checkpoint (unet_d2, the smallest: the JAX CLI's own
eager flax init costs ~1 s a parameter on this CPU; batch norm with moved
running averages; a JAX test-phase model's G converted) through the JAX CLI
(``infer.main``) and the port's (``biasgan_tpu_torch.infer.main``) on a
toy climate store, within 2e-4 (tests/port/test_torch_port_infer.py's
bound); and the port's sharded serve of it (--spatial_mesh 2, two spawned
gloo ranks, batch norm from its running averages, W halos wrapped) within
2e-4 of its one-device serve."""

import os
import re

import h5py
import jax
import numpy as np
import pytest
import torch

import infer as jax_infer
from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.models import create_model
from biasgan_tpu_torch import infer as port_infer
from biasgan_tpu_torch import train
from biasgan_tpu_torch.convert import params_to_state_dict
from biasgan_tpu_torch.nn.generators import UNetGenerator
from biasgan_tpu_torch.nn.layers import BatchNorm

TINY = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--netG", "unet_d4",
    "--crop_size", "64", "--input_nc", "1", "--output_nc", "1", "--batch_size", "4",
    "--ngf", "16", "--ndf", "16", "--synthetic_samples", "16", "--n_epochs", "1",
    "--n_epochs_decay", "1", "--print_freq", "4", "--save_epoch_freq", "1",
    "--lr_policy", "step", "--device", "cpu",
]
LOSS_LINE = re.compile(r"^\(epoch: (\d+), iters: (\d+), time: [0-9.]+, data: [0-9.]+\) "
                       r"G_GAN: ([-0-9.]+) G_L1: ([-0-9.]+) D_real: ([-0-9.]+) "
                       r"D_fake: ([-0-9.]+)$")



@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread here: after JAX has run in the process its
    thread pool's workers spin for a while, and torch's own pool of a
    thread per core then contends with them (a 10x slower tiny drive on
    this file's first measurement)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

def _train(capsys, ckpt, name, *extra):
    state = train.main(TINY + ["--checkpoints_dir", str(ckpt), "--name", name, *extra])
    return state, capsys.readouterr().out


def _lines(out):
    return [LOSS_LINE.match(ln).groups() for ln in out.splitlines() if LOSS_LINE.match(ln)]


def test_tiny_drive_trains_saves_and_resumes_bitwise(tmp_path, capsys):
    state, out = _train(capsys, tmp_path, "full")
    lines = _lines(out)
    assert [ln[:2] for ln in lines] == [("1", "4"), ("1", "8"), ("1", "12"), ("1", "16"),
                                        ("2", "20"), ("2", "24"), ("2", "28"), ("2", "32")]
    g_l1 = [float(ln[3]) for ln in lines]
    assert g_l1[-1] < g_l1[0], g_l1
    run = tmp_path / "full"
    for tag in ("latest", "epoch_1", "epoch_2"):
        assert (run / "ckpt" / f"{tag}.pt").is_file()
        for net in ("G", "D"):
            assert (run / f"{tag}_net_{net}.pth").is_file()

    resumed = tmp_path / "resumed"
    os.makedirs(resumed / "ckpt")
    os.link(run / "ckpt" / "epoch_1.pt", resumed / "ckpt" / "epoch_1.pt")
    _, res = _train(capsys, tmp_path, "resumed", "--continue_train", "--epoch", "epoch_1",
                    "--epoch_count", "2")
    assert "resumed training state 'epoch_1' at step 4" in res
    assert [ln[2:] for ln in _lines(res)] == [ln[2:] for ln in lines[4:]]
    want = torch.load(run / "ckpt" / "epoch_2.pt", weights_only=True)
    got = torch.load(resumed / "ckpt" / "epoch_2.pt", weights_only=True)

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
    assert int(want["nets"]["D"]["norms.1.num_batches_tracked"]) == 8 * 3


def test_defaults_train_unet_256_with_batch_norm_and_dropout(tmp_path, capsys):
    state = train.main(["--model", "pix2pix", "--dataset_mode", "synthetic", "--device", "cpu",
                        "--ngf", "2", "--ndf", "2", "--input_nc", "1", "--output_nc", "1",
                        "--synthetic_samples", "1", "--n_epochs", "1", "--n_epochs_decay",
                        "0", "--print_freq", "1", "--checkpoints_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "netG: unet_256" in out and "norm: batch" in out and "no_dropout: False" in out
    G = state.nets["G"]
    assert isinstance(G, UNetGenerator) and G.num_downs == 8 and sorted(G.drop_at) == [4, 5, 6]
    assert any(isinstance(m, BatchNorm) for m in G.modules())
    (line,) = _lines(out)
    assert all(np.isfinite(float(v)) for v in line[2:])


def test_eval_fn_modes():
    """``make_eval_fn``: in eval mode G's running averages normalize and
    stay; with ``train=True`` (the reference's test without --eval) batch
    statistics normalize, the running averages stay as they were (JAX
    drops the update), and dropout draws from the generator given."""
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.models.pix2pix import create_state, make_eval_fn

    cfg = parse_config(["--model", "pix2pix", "--dataset_mode", "synthetic", "--netG",
                        "unet_d6", "--crop_size", "64", "--input_nc", "1", "--output_nc", "1",
                        "--ngf", "4", "--device", "cpu"])
    state = create_state(cfg, torch.device("cpu"))
    G = state.nets["G"].eval()
    assert sorted(G.drop_at) == [4] and "D" not in state.nets and not state.opts
    x = torch.randn(2, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    eval_fn = make_eval_fn(cfg)
    before = {k: v.clone() for k, v in G.state_dict().items()}
    out = eval_fn(state, {"A": x, "B": x})
    with torch.no_grad():
        assert torch.equal(out["fake_B"], G(x)) and torch.equal(out["real_A"], x)
    assert all(torch.equal(v, before[k]) for k, v in G.state_dict().items())

    def trained(seed):
        return eval_fn(state, {"A": x, "B": x}, torch.Generator().manual_seed(seed),
                       train=True)["fake_B"]

    assert not torch.allclose(trained(1), out["fake_B"]) and not G.training
    assert not torch.equal(trained(1), trained(2))
    assert all(torch.equal(v, before[k]) for k, v in G.state_dict().items())


@pytest.mark.parametrize("flags,note", [
    (["--fused_blocks"], "--fused_blocks: ignored — netG 'unet_d4' has no resnet block chain"),
    (["--pallas_conv", "1"], "--pallas_conv: ignored — netG 'unet_d4' has no 3x3 stride-1"),
    (["--conv7_pallas", "1"], "--conv7_pallas: ignored — netG 'unet_d4' has no 7x7 conv"),
    (["--force_pallas_norm", "--norm", "instance"],
     "--force_pallas_norm: engaged on the D's instance norms only"),
])
def test_unet_routing_notices(flags, note):
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.models.pix2pix import create_state

    cfg = parse_config(TINY + flags, train=True)
    (line,) = train.routing_notices(cfg, create_state(cfg, torch.device("cpu")))
    assert line.startswith(note), line


H, W, NC = 24, 64, 2


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("unet_globe")
    for side, seed in (("A", 0), ("B", 1)):
        d = root / "data" / ("test" + side)
        os.makedirs(d)
        rng = np.random.default_rng(seed)
        with h5py.File(d / "data.h5", "w") as f:
            f["t2m"] = rng.normal(280.0, 10.0, (2, H, W)).astype(np.float32)
            f["precip"] = rng.gamma(2.0, 1.0, (2, H, W)).astype(np.float32)
    model = create_model(jax_parse_config(_serve_args(root), train=False))
    g = model.state.nets["G"]
    stats = jax.tree_util.tree_map(lambda v: v * 1.5 + 0.1, g["batch_stats"])
    model.state = model.state.replace(nets={"G": {**g, "batch_stats": stats}})
    model.save_networks("latest")
    torch.save(params_to_state_dict(g["params"], stats),
               os.path.join(model.run_dir, "latest_net_G.pth"))
    return root


def _serve_args(root, *extra):
    return ["--model", "pix2pix", "--dataset_mode", "climate",
            "--dataroot", str(root / "data"), "--checkpoints_dir", str(root / "ckpts"),
            "--name", "unet", "--netG", "unet_d2", "--norm", "batch", "--no_dropout",
            "--input_nc", str(NC), "--output_nc", str(NC), "--ngf", "8",
            "--w_pad_mode", "wrap", "--netG_activation", "none", "--crop_size", "32",
            "--full_field", "--num_test", "2", *extra]


def _fields(out_dir):
    files = sorted(os.listdir(out_dir))
    assert files == ["corrected_00000.npy", "corrected_00001.npy"]
    return [np.load(os.path.join(out_dir, f)) for f in files]


def test_unet_serve_matches_jax_cli_and_shards(store):
    want = _fields(jax_infer.main(_serve_args(store, "--results_dir", str(store / "jax"))))
    got = _fields(port_infer.main(_serve_args(store, "--results_dir", str(store / "port"),
                                              "--device", "cpu")))
    sharded = _fields(port_infer.main(_serve_args(
        store, "--results_dir", str(store / "sharded"), "--device", "cpu",
        "--spatial_mesh", "2")))
    for g, w, s in zip(got, want, sharded):
        assert g.shape == w.shape == s.shape == (1, H, W, NC) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(s, g, rtol=2e-4, atol=2e-4)
