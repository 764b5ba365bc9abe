"""The training CLI of the PyTorch port, ``python -m biasgan_tpu_torch.train``,
on the CPU with the flags of tests/integration/test_train_fused_cli.py:
the fused-block route engages and says so, the reference loss lines reach
stdout and ``loss_log.txt``, the full state and the per-net weights are
saved at the cadences, the inference CLI's loader takes G_A from the run,
and a run resumed from the epoch-1 state ends epoch 2 bit-exact with an
uninterrupted one (pool, Adam moments, step and augmentation draws
included)."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.join(os.path.dirname(__file__), "..", "..")
BASE = [
    "--model", "cycle_gan", "--dataset_mode", "synthetic",
    "--norm", "instance", "--no_dropout",
    "--netD", "basic", "--gan_mode", "lsgan", "--pool_size", "4",
    "--crop_size", "32", "--input_nc", "1", "--output_nc", "1",
    "--batch_size", "2", "--ngf", "8", "--ndf", "8",
    "--synthetic_samples", "4", "--print_freq", "2",
    "--n_epochs", "1", "--n_epochs_decay", "1", "--save_epoch_freq", "1",
    "--netG", "resnet_3blocks", "--device", "cpu",
    # a resumed run with --epoch_count N counts N on top of the restored
    # step under the linear policy, as the JAX CLI does; the step policy
    # reads the step alone
    "--lr_policy", "step",
]
LOSS_LINE = re.compile(
    r"^\(epoch: (\d+), iters: (\d+), time: [0-9.]+, data: [0-9.]+\) D_A: [-0-9.]+ "
    r"G_A: [-0-9.]+ cycle_A: [-0-9.]+ idt_A: [-0-9.]+ D_B: [-0-9.]+ G_B: [-0-9.]+ "
    r"cycle_B: [-0-9.]+ idt_B: [-0-9.]+$"
)


def _train(ckpt, name, *extra):
    cmd = [sys.executable, "-m", "biasgan_tpu_torch.train", *BASE,
           "--checkpoints_dir", str(ckpt), "--name", name, *extra]
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return p.stdout


def _losses(out, epoch):
    return [ln.split(") ", 1)[1] for ln in out.splitlines()
            if LOSS_LINE.match(ln) and LOSS_LINE.match(ln).group(1) == str(epoch)]


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("train_cli")
    return ckpt, _train(ckpt, "full", "--fused_blocks")


def test_train_cli_loss_lines_and_checkpoints(full_run):
    ckpt, out = full_run
    run = ckpt / "full"
    assert "--fused_blocks: fused training path engaged" in out
    lines = [ln for ln in out.splitlines() if LOSS_LINE.match(ln)]
    assert [LOSS_LINE.match(ln).groups() for ln in lines] == [
        ("1", "2"), ("1", "4"), ("2", "6"), ("2", "8")]
    with open(run / "loss_log.txt") as f:
        assert [ln for ln in f.read().splitlines() if LOSS_LINE.match(ln)] == lines
    assert "End of epoch 2 / 2" in out
    for tag in ("latest", "epoch_1", "epoch_2"):
        assert (run / "ckpt" / f"{tag}.pt").is_file()
        for net in ("G_A", "G_B", "D_A", "D_B"):
            assert (run / f"{tag}_net_{net}.pth").is_file()
    state = torch.load(run / "ckpt" / "latest.pt", weights_only=True)
    assert state["step"] == 4 and state["meta"] == {"host_step": 4, "epoch": 2}
    assert state["opts"]["G"]["count"] == 4 and state["pools"]["fake_B"]["count"] == 4
    assert "lr: 2.000e-04" in out.splitlines()[-1]


def test_inference_loads_the_trained_generator(full_run):
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.infer import build_generator

    ckpt, _ = full_run
    cfg = parse_config(["--model", "cycle_gan", "--dataset_mode", "synthetic",
                        "--netG", "resnet_3blocks", "--ngf", "8",
                        "--input_nc", "1", "--output_nc", "1", "--no_dropout",
                        "--checkpoints_dir", str(ckpt), "--name", "full", "--device", "cpu"])
    G = build_generator(cfg, torch.device("cpu"))
    want = torch.load(ckpt / "full" / "latest_net_G_A.pth", weights_only=True)
    for k, v in G.state_dict().items():
        assert torch.equal(v, want[k])


@pytest.mark.parametrize("flags,notes", [
    (["--fused_blocks", "--pallas_conv", "1"],
     ["--fused_blocks: fused training path engaged",
      "--pallas_conv: ignored — --fused_blocks takes the block convs"]),
    (["--pallas_conv", "1", "--fused_updown"],
     ["--fused_updown: ignored — the fused down/up kernels are inference-only",
      "--pallas_conv: engaged"]),
    (["--fused_blocks", "--no-no_dropout", "--conv7_pallas", "1", "--force_pallas_norm"],
     ["--fused_blocks: ignored — dropout is on"]
     + [f"--conv7_pallas: the {g} {c} stays on cuDNN" for g in ("G_A", "G_B")
        for c in ("stem", "head")]
     + ["--force_pallas_norm: engaged"]),
])
def test_train_routing_notices(flags, notes):
    """Every kernel flag says whether it engaged in training, or why not
    (ngf 8: the 7x7 convs have no channel side of at most 8 on one side
    only)."""
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.models.cyclegan import create_state
    from biasgan_tpu_torch.train import routing_notices

    cfg = parse_config(BASE + flags, train=True)
    got = routing_notices(cfg, create_state(cfg, torch.device("cpu")))
    assert len(got) == len(notes)
    for line, want in zip(got, notes):
        assert line.startswith(want), (line, want)


def test_train_cli_resume_is_bit_exact(full_run, tmp_path):
    """Resume epoch 2 from the epoch-1 state: the same losses and the same
    final state, tensor for tensor."""
    ckpt, out = full_run
    shutil.copytree(ckpt / "full", tmp_path / "resumed")
    for f in (tmp_path / "resumed" / "ckpt").iterdir():
        if not f.name.startswith("epoch_1"):
            f.unlink()
    res = _train(tmp_path, "resumed", "--fused_blocks", "--continue_train",
                 "--epoch", "epoch_1", "--epoch_count", "2")
    assert "resumed training state 'epoch_1' at step 2" in res
    assert _losses(res, 1) == [] and _losses(res, 2) == _losses(out, 2)
    want = torch.load(ckpt / "full" / "ckpt" / "epoch_2.pt", weights_only=True)
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
