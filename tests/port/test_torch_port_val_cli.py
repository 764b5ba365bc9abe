"""``python -m biasgan_tpu_torch.train`` with data parallelism and the
validation flags, on the CPU (gloo ranks), for pix2pix and CycleGAN
(synthetic data): the sample counts, both validation lines, no plateau
warning, every rank's state bitwise equal; the validation lines of a
sharded CycleGAN run (the W shards gathered) equal the one-device run's;
the plateau policy takes the held-out RMSE; and the flag combinations that
raise."""

import contextlib
import io
import re

import pytest

from biasgan_tpu_torch import train

COMMON = [
    "--dataset_mode", "synthetic", "--crop_size", "32", "--input_nc", "1",
    "--output_nc", "1", "--ngf", "8", "--ndf", "8", "--synthetic_samples", "12",
    "--val_split", "4", "--val_freq", "8", "--lr_policy", "plateau", "--print_freq", "4",
    "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq", "5", "--device", "cpu",
]
P2P = ["--model", "pix2pix", "--netG", "unet_d4", "--batch_size", "4"] + COMMON
CG = ["--model", "cycle_gan", "--netG", "resnet_3blocks", "--batch_size", "2",
      "--pool_size", "4", "--fused_blocks"] + COMMON
METRICS = re.compile(r"^validation \((train batch|held out)\): rmse: (\S+) bias: (\S+) "
                     r"pdf_tv: (\S+) log_spectral_distance: (\S+)$", re.M)


def _run(argv, tmp_path, name):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = train.main(argv + ["--checkpoints_dir", str(tmp_path), "--name", name])
    return out.getvalue(), result


@pytest.mark.parametrize("argv,train_images", [(P2P, 8), (CG, 8)], ids=["pix2pix", "cycle_gan"])
def test_data_mesh_cli_validates_and_stays_replicated(argv, train_images, tmp_path):
    out, result = _run(argv + ["--data_mesh", "2"], tmp_path, "dp")
    assert "data: 2 rank(s) (rank->device 0->cpu, 1->cpu), backend gloo" in out
    assert f"The number of training images = {train_images}" in out
    assert "The number of validation images = 4" in out
    kinds = [m.group(1) for m in METRICS.finditer(out)]
    assert kinds == ["train batch", "held out"], out
    assert "plateau policy found no rmse metric" not in out
    assert len(re.findall(r"^\(epoch: 1, iters: \d+,", out, re.M)) == train_images // 4
    assert "data: parameters bitwise equal on every rank: True" in out
    assert result["params_equal"] and len(result["launches"]) == 2
    steps = train_images // int(argv[argv.index("--batch_size") + 1])
    assert [r["grad_reduces"] for r in result["ranks"]] == [2 * steps] * 2  # G and D
    assert len(result["step_ms"]) == steps
    assert "End of epoch 1 / 1" in out


def test_sharded_validation_equals_one_device(tmp_path):
    """CycleGAN under --spatial_mesh 2 (periodic W): its validation lines,
    of the gathered W, are the one-device run's: rmse, bias and the
    log-spectral distance to the printed digits (2e-4); pdf_tv within 1% of
    the pixels (20 of 2048), since the sharded forward equals the whole
    field's up to rounding, and a fake near a bin edge may change bin (a
    run read 6 counts). At --lr 0, so that every validation point sees the
    same nets in both runs (a step amplifies rounding: Adam's first updates
    go by the signs of gradients within rounding of zero)."""
    argv = CG + ["--w_pad_mode", "wrap", "--no-in_graph_aug", "--lr", "0"]
    one, _ = _run(argv, tmp_path, "one")
    sharded, result = _run(argv + ["--spatial_mesh", "2"], tmp_path, "sharded")
    assert result["params_equal"]
    want, got = METRICS.findall(one), METRICS.findall(sharded)
    assert len(want) == len(got) == 2
    for w, g in zip(want, got):
        assert w[0] == g[0]
        for a, b, tol in zip(w[1:], g[1:], (2e-4, 2e-4, 0.01, 2e-4)):
            assert abs(float(a) - float(b)) <= tol, (w, g)


def test_plateau_takes_the_held_out_rmse(tmp_path, monkeypatch):
    """One device, --val_freq at the epoch's last step: the metric the
    plateau policy gets at each epoch's end is the held-out RMSE that the
    last validation line printed (every held-out batch: both of them)."""
    seen = []
    real = train.plateau_update
    monkeypatch.setattr(train, "plateau_update",
                        lambda state, plateau, m: (seen.append(m), real(state, plateau, m)))
    out, _ = _run(P2P + ["--n_epochs_decay", "1"], tmp_path, "plateau")
    held = [float(m.group(2)) for m in METRICS.finditer(out) if m.group(1) == "held out"]
    assert len(seen) == len(held) == 2
    for s, h in zip(seen, held):
        assert abs(s - h) <= 5e-5


def test_mesh_flags_that_raise(tmp_path):
    """The 2-D mesh runs (test_torch_port_mesh_2d.py); what it refuses
    before any spawn: a global batch that does not split over the data
    ranks, and a W that does not split over the W shards' 2^downs."""
    base = P2P + ["--checkpoints_dir", str(tmp_path), "--name", "bad"]
    mesh = ["--spatial_mesh", "2", "--w_pad_mode", "wrap"]
    with pytest.raises(ValueError, match=r"--batch_size 2 .* --data_mesh 4"):
        train.main(CG + ["--checkpoints_dir", str(tmp_path), "--name", "bad", "--data_mesh",
                         "4"] + mesh)
    with pytest.raises(ValueError, match=r"--batch_size 4 .* --data_mesh 3"):
        train.main(base + ["--data_mesh", "3"])
    # unet_d4: 2 shards x 2^4 = 32 columns a unit; a 48-wide crop is 1.5 units
    with pytest.raises(ValueError, match=r"--crop_size 48 .* --spatial_mesh 2 .* 2 x 2\^4 = 32"):
        train.main(base + ["--data_mesh", "2", "--crop_size", "48"] + mesh)
    with pytest.raises(ValueError, match=r"--crop_size 36 .* --spatial_mesh 4 .* 4 x 2\^2 = 16"):
        train.main(CG + ["--checkpoints_dir", str(tmp_path), "--name", "bad", "--data_mesh",
                         "2", "--spatial_mesh", "4", "--w_pad_mode", "wrap", "--crop_size", "36"])
