"""``python -m biasgan_tpu_torch.train --steps_per_call 2`` on the CPU, on a
dataset of an odd batch count (10 samples at batch 2: five batches, two
calls an epoch, the fifth batch dropped), against the repo-root JAX
``train.py`` on the same command line: the loss lines' epochs and
``total_iters`` (4 and 8 each epoch, advancing by batch_size x K), and
each epoch's LR line (the step policy, decayed by the step counter over
``steps_per_epoch = len(dataset)`` = 5 although an epoch takes 4 steps, as
the JAX CLI counts it). Then the port's run resumed from its epoch-1
state ends bitwise equal to the uninterrupted run: the loss lines of
epochs 2 and 3 and the saved state, tensor for tensor (``host_step``
counts steps, so the resumed calls draw what the uninterrupted ones do).
Both CLIs run in this process (the JAX one compiles its scan once, ~25 s
on a CPU)."""

import contextlib
import importlib.util
import io
import os
import re
import shutil

import torch

from biasgan_tpu_torch import train

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARGS = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--netG", "unet_d4",
    "--crop_size", "32", "--input_nc", "1", "--output_nc", "1", "--batch_size", "2",
    "--ngf", "8", "--ndf", "8", "--synthetic_samples", "10", "--steps_per_call", "2",
    "--n_epochs", "1", "--n_epochs_decay", "2", "--lr_policy", "step",
    "--lr_decay_iters", "1", "--print_freq", "2", "--save_epoch_freq", "1",
]
LOSS_LINE = re.compile(r"^\(epoch: (\d+), iters: (\d+), time: [0-9.]+, data: [0-9.]+\) (.*)$")
LR_LINE = re.compile(r"^End of epoch (\d+) / (\d+) \t Time: [0-9.]+s \t lr: (\S+)$")


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _lines(out):
    loss = [(m.group(1), m.group(2), m.group(3)) for m in map(LOSS_LINE.match,
                                                               out.splitlines()) if m]
    lr = [m.groups() for m in map(LR_LINE.match, out.splitlines()) if m]
    return loss, lr


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_train_cli", os.path.join(REPO,
                                                                               "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_k_step_cli_matches_the_jax_cli_and_resumes_bitwise(tmp_path):
    port = _run(train.main, ARGS + ["--checkpoints_dir", str(tmp_path), "--name", "port",
                                    "--device", "cpu"])
    ref = _run(_jax_cli(), ARGS + ["--checkpoints_dir", str(tmp_path), "--name", "jax"])
    (loss, lr), (jloss, jlr) = _lines(port), _lines(ref)
    iters = [("1", "4"), ("1", "8"), ("2", "12"), ("2", "16"), ("3", "20"), ("3", "24")]
    assert [x[:2] for x in loss] == [x[:2] for x in jloss] == iters
    assert lr == jlr and [x[2] for x in lr] == ["2.000e-04", "2.000e-05", "2.000e-06"]
    names = [re.findall(r"(\w+): ", x[2]) for x in loss]
    assert all(sorted(n) == sorted(re.findall(r"(\w+): ", jloss[0][2])) for n in names)
    state = torch.load(tmp_path / "port" / "ckpt" / "latest.pt", weights_only=True)
    assert state["step"] == 12 and state["meta"] == {"host_step": 12, "epoch": 3}

    # resume epochs 2-3 from the epoch-1 state
    shutil.copytree(tmp_path / "port", tmp_path / "resumed")
    for f in (tmp_path / "resumed" / "ckpt").iterdir():
        if not f.name.startswith("epoch_1"):
            f.unlink()
    res = _run(train.main, ARGS + ["--checkpoints_dir", str(tmp_path), "--name", "resumed",
                                   "--device", "cpu", "--continue_train", "--epoch",
                                   "epoch_1", "--epoch_count", "2"])
    assert "resumed training state 'epoch_1' at step 4" in res
    rloss, rlr = _lines(res)
    assert [(e, i) for e, i, _ in rloss] == iters[2:]
    assert [x[2] for x in rloss] == [x[2] for x in loss[2:]] and rlr == lr[1:]
    _same(torch.load(tmp_path / "resumed" / "ckpt" / "epoch_3.pt", weights_only=True),
          torch.load(tmp_path / "port" / "ckpt" / "epoch_3.pt", weights_only=True), "state")
