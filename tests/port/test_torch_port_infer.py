"""The inference slice end to end: the JAX CLI (infer.main) and the port's
CLI (biasgan_tpu_torch.infer.main) on the toy climate store of
tests/integration/test_infer_globe.py, with the port's weights converted
from the JAX checkpoint. Plain path, and --fused_blocks (the JAX side in
Pallas interpret mode; the port's conv3x3_fused on the CPU is its plain
version), and the kernel routes --fused_blocks --fused_updown
--conv7_pallas 1 and --force_pallas_norm (ngf 16, so that the 7x7 stem and
head each have one tiny channel side). The corrected .npy fields agree to
2e-4."""

import os

import h5py
import numpy as np
import pytest

import infer as jax_infer
from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.models import create_model
from biasgan_tpu_torch import infer as port_infer
from biasgan_tpu_torch.convert import params_to_state_dict
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.nn import define_G

H, W, T, NC = 24, 64, 3, 2
TOL = 2e-4


def _common_args(root, ngf=8):
    return [
        "--model", "pix2pix", "--dataset_mode", "climate",
        "--dataroot", str(root / "data"),
        "--checkpoints_dir", str(root / "ckpts"), "--name", "globe",
        "--netG", "resnet_3blocks", "--norm", "instance", "--no_dropout",
        "--input_nc", str(NC), "--output_nc", str(NC),
        "--ngf", str(ngf), "--w_pad_mode", "wrap", "--netG_activation", "none",
        "--crop_size", "32", "--full_field",
    ]


def _infer_args(root, *extra, ngf=8):
    return _common_args(root, ngf) + ["--num_test", "2", *extra]


def _make_store(tmp_path_factory, ngf):
    root = tmp_path_factory.mktemp(f"port_globe_{ngf}")
    for side, seed in (("A", 0), ("B", 1)):
        d = root / "data" / ("test" + side)
        os.makedirs(d)
        rng = np.random.default_rng(seed)
        with h5py.File(d / "data.h5", "w") as f:
            f["t2m"] = rng.normal(280.0, 10.0, (T, H, W)).astype(np.float32)
            f["precip"] = rng.gamma(2.0, 1.0, (T, H, W)).astype(np.float32)
    # a trained-checkpoint stand-in: a train-phase JAX model saved as
    # 'latest', and the same G weights as the port's latest_net_G.pth
    cfg = jax_parse_config(
        _common_args(root, ngf) + ["--phase", "train", "--batch_size", "1"], train=True
    )
    model = create_model(cfg)
    model.save_networks("latest")
    import torch

    g = model.state.nets["G"]
    sd = params_to_state_dict(g["params"], g.get("batch_stats"))
    torch.save(sd, os.path.join(cfg.run_dir(), "latest_net_G.pth"))
    return root


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return _make_store(tmp_path_factory, 8)


@pytest.fixture(scope="module")
def store16(tmp_path_factory):
    return _make_store(tmp_path_factory, 16)


def _fields(out_dir):
    files = sorted(os.listdir(out_dir))
    assert files == ["corrected_00000.npy", "corrected_00001.npy"]
    return [np.load(os.path.join(out_dir, f)) for f in files]


@pytest.mark.parametrize("fused", [False, True])
def test_port_cli_matches_jax_cli(store, fused, monkeypatch):
    extra = ["--fused_blocks"] if fused else []
    if fused:
        monkeypatch.setenv("BIASGAN_FUSED_BLOCK", "interpret")
        monkeypatch.setenv("BIASGAN_FUSED_MIN_C", "1")  # toy ngf=8 -> C=32
    tag = "fused" if fused else "plain"
    want = _fields(jax_infer.main(
        _infer_args(store, *extra, "--results_dir", str(store / f"jax_{tag}"))
    ))
    got = _fields(port_infer.main(_infer_args(
        store, *extra, "--results_dir", str(store / f"port_{tag}"), "--device", "cpu"
    )))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, H, W, NC) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_port_cli_refuses_spatial_sharding(store):
    for flags in (["--spatial_mesh", "2"], ["--halo_rdma"]):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            port_infer.main(_infer_args(store, *flags, "--device", "cpu"))


def test_port_cli_fused_notice_for_unfusable_generator(store, capsys):
    """--fused_blocks is never ignored silently."""
    port_infer.main(_infer_args(
        store, "--fused_blocks", "--no-no_dropout",
        "--results_dir", str(store / "port_notice"), "--device", "cpu",
    ))
    assert "--fused_blocks: ignored — dropout is on" in capsys.readouterr().out


@pytest.mark.parametrize("model,extra,g_name", [
    ("pix2pix", [], "G"),
    ("cycle_gan", ["--direction", "BtoA"], "G_B"),
    ("test", ["--model_suffix", "_A"], "G_A"),
])
def test_config_flags_match_jax_parser(model, extra, g_name):
    """Same command line, same values for every field the port keeps; the
    model and dataset plugins inject their flags and defaults, and the
    model names the generator checkpoint to load."""
    from biasgan_tpu_torch.registry import get_model

    argv = ["--model", model, "--dataset_mode", "climate", "--ngf", "16",
            "--variables", "t2m", *extra]
    mine = parse_config(argv)
    ref = jax_parse_config(argv, train=False)
    assert mine.phase == "test" and mine.device == "cuda"
    assert mine.variables == "t2m"
    for k in ("netG", "norm", "no_dropout", "netG_activation", "ngf", "direction",
              "batch_size", "serial_batches", "epoch", "w_pad_mode", "fused_blocks",
              "fused_updown", "conv7_pallas", "force_pallas_norm", "pallas_conv"):
        assert getattr(mine, k) == getattr(ref, k), k
    assert get_model(model).generator_name(mine) == g_name
    # the training options: the model's train defaults (cycle_gan: lsgan,
    # pool 50; pix2pix: vanilla, no pool; test: refused) and the TrainConfig
    # fields the port reads
    if model == "test":
        for parse in (parse_config, jax_parse_config):
            with pytest.raises(ValueError, match="test-time only"):
                parse(argv, train=True)
        return
    mine, ref = parse_config(argv, train=True), jax_parse_config(argv, train=True)
    assert mine.phase == "train"
    for k in ("pool_size", "gan_mode", "lr", "beta1", "n_epochs", "n_epochs_decay",
              "epoch_count", "lr_policy", "lr_decay_iters", "print_freq", "save_epoch_freq",
              "save_latest_freq", "in_graph_aug", "aug_lon_roll", "no_flip", "netD", "ndf",
              "n_layers_D", "adam_mu_dtype", "continue_train"):
        assert getattr(mine, k) == getattr(ref, k), k


@pytest.mark.parametrize("route", ["fused_all", "plain_norm"])
def test_port_cli_kernel_routes_match_jax_cli(store16, route, monkeypatch):
    """The same command line through both CLIs; the JAX side opens its
    routes in interpret mode (its --force_pallas_norm takes the op's plain
    reference off the TPU)."""
    if route == "fused_all":
        extra = ["--fused_blocks", "--fused_updown", "--conv7_pallas", "1"]
        for k, v in (("BIASGAN_FUSED_BLOCK", "interpret"), ("BIASGAN_FUSED_MIN_C", "1"),
                     ("BIASGAN_CONV7", "interpret"), ("BIASGAN_S2D_MIN_M", "1")):
            monkeypatch.setenv(k, v)
    else:
        extra = ["--force_pallas_norm"]
    want = _fields(jax_infer.main(_infer_args(
        store16, *extra, "--results_dir", str(store16 / f"jax_{route}"), ngf=16)))
    got = _fields(port_infer.main(_infer_args(
        store16, *extra, "--results_dir", str(store16 / f"port_{route}"),
        "--device", "cpu", ngf=16)))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, H, W, NC)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("flags,norm,ngf,notes", [
    (["--fused_updown"], "instance", 16,
     ["--fused_updown: ignored — it needs --fused_blocks"]),
    (["--fused_blocks", "--fused_updown", "--no-no_dropout"], "instance", 16,
     ["--fused_blocks: ignored — dropout is on", "--fused_updown: ignored — dropout is on"]),
    (["--conv7_pallas", "1"], "instance", 8,
     ["--conv7_pallas: the stem (2 -> 8 channels) stays on cuDNN",
      "--conv7_pallas: the head (8 -> 2 channels) stays on cuDNN"]),
    (["--force_pallas_norm"], "batch", 16,
     ["--force_pallas_norm: ignored — norm 'batch' is not instance norm"]),
    (["--force_pallas_norm", "--fused_blocks", "--fused_updown"], "instance", 16,
     ["--force_pallas_norm: ignored — with --fused_blocks and --fused_updown"]),
    (["--fused_blocks", "--fused_updown", "--conv7_pallas", "1", "--force_pallas_norm"],
     "batch", 16, ["--fused_blocks: ignored", "--fused_updown: ignored",
                   "--force_pallas_norm: ignored"]),
    (["--fused_blocks", "--fused_updown", "--conv7_pallas", "1"], "instance", 16, []),
])
def test_routing_notices(tmp_path, flags, norm, ngf, notes):
    """Every kernel flag that cannot engage says why."""
    argv = _infer_args(tmp_path, *flags, ngf=ngf)
    argv[argv.index("--norm") + 1] = norm
    cfg = parse_config(argv)
    G = define_G(cfg.netG, cfg.input_nc, cfg.output_nc, ngf=cfg.ngf, norm=cfg.norm).eval()
    got = port_infer.routing_notices(cfg, G)
    assert len(got) == len(notes)
    for line, want in zip(got, notes):
        assert line.startswith(want), (line, want)
    with pytest.raises(ValueError, match="--conv7_pallas"):
        port_infer.conv7_on("yes")
