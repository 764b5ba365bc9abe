"""The port's image datasets and page writers against the JAX package's, on
a few small PNGs written to tmp_path, bit for bit (both read with PIL and
transform on the host with numpy):

* 'unaligned' and 'single': each sample's arrays, paths and B index, in
  epochs 0 and 1, with and without --serial_batches, AtoB and BtoA, RGB
  and grayscale sides, and --max_dataset_size; each package's loader
  batch by batch; the held-out loader of a 'val' phase (valA/ and valB/,
  or the single dataset's --dataroot) against the JAX CLI's
  ``_build_val_loader``, and None where the directories are missing;
* ``tensor2im`` (tanh range, a standardized field, one channel, a bf16
  tensor), ``save_image`` (--aspect_ratio above and below 1) and the HTML
  pages: the same pixels and the same ``index.html`` text;
* ``Visualizer``: the loss line and ``loss_log.txt``, and the snapshot
  pages over two epochs and again in a new instance (a resumed run), the
  same images and page text as the JAX ``Visualizer``;
* ``diagnostics``: the JAX values and messages;
* ``python -m biasgan_tpu_torch.train --model cycle_gan`` at its default
  dataset_mode (unaligned) on PNG directories: one step.
"""

import contextlib
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import train as jax_train_cli
from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.data import create_dataset as jax_create_dataset
from biasgan_tpu.utils import diagnostics as jax_diag
from biasgan_tpu.utils import html as jax_html
from biasgan_tpu.utils import imaging as jax_imaging
from biasgan_tpu.utils.visualizer import Visualizer as JaxVisualizer
from biasgan_tpu_torch import train
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.data import create_dataset
from biasgan_tpu_torch.utils import diagnostics, html, imaging
from biasgan_tpu_torch.utils.visualizer import Visualizer

SIZES = {"A": [(40, 48), (44, 40), (40, 40), (48, 52), (40, 44)], "B": [(40, 40), (52, 44),
                                                                       (40, 48)]}


def _write_side(d, sizes, rng):
    d.mkdir(parents=True)
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(d / f"{d.name}_{i:02d}.png")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """trainA/ (5 images) and trainB/ (3), valA/ and valB/ (2 each), of
    assorted sizes; a second root with no val directories."""
    root = tmp_path_factory.mktemp("unaligned")
    rng = np.random.default_rng(0)
    for side, sizes in SIZES.items():
        _write_side(root / f"train{side}", sizes, rng)
        _write_side(root / f"val{side}", sizes[:2], rng)
    bare = tmp_path_factory.mktemp("bare")
    for side in "AB":
        _write_side(bare / f"train{side}", SIZES[side][:2], rng)
    return root, bare


def _both(argv, train_cfg=True):
    return parse_config(argv, train=train_cfg), jax_parse_config(argv, train=train_cfg)


def _same_sample(got, want, keys):
    assert got.keys() == want.keys()
    for k in keys:
        assert got[k].dtype == np.float32 and got[k].shape[-3:-1] == (32, 32)
        np.testing.assert_array_equal(got[k], want[k])
    for k in got:
        if k.endswith("_paths"):
            assert got[k] == want[k]


@pytest.mark.parametrize("extra", [
    [],
    ["--serial_batches"],
    ["--direction", "BtoA", "--input_nc", "1"],
    ["--output_nc", "1", "--max_dataset_size", "2", "--preprocess", "crop"],
])
def test_unaligned_matches_jax(root, extra):
    argv = ["--model", "cycle_gan", "--dataroot", str(root[0]), "--load_size", "36",
            "--crop_size", "32", "--batch_size", "2", "--seed", "3", *extra]
    cfg, jcfg = _both(argv)
    assert cfg.dataset_mode == jcfg.dataset_mode == "unaligned"
    jax_loader, loader = jax_create_dataset(jcfg), create_dataset(cfg)
    jd, d = jax_loader.dataset, loader.dataset
    capped = "--max_dataset_size" in extra
    assert len(d) == len(jd) == (2 if capped else 5)
    b_seen = set()
    for epoch in (0, 1):
        jd.epoch = d.epoch = epoch
        for i in range(len(d)):
            got, want = d[i], jd[i]
            _same_sample(got, want, ("A", "B"))
            b_seen.add(got["B_paths"])
            if "--serial_batches" in extra:
                assert got["B_paths"] == d.B_paths[i % len(d.B_paths)]
    # the random B index reaches past the serial one's pattern
    assert len(b_seen) == (2 if capped else 3)
    batches = list(zip(jax_loader, loader))
    assert len(batches) == len(d) // 2
    for want, got in batches:
        _same_sample(got, want, ("A", "B"))


@pytest.mark.parametrize("extra", [[], ["--input_nc", "1", "--no-no_flip"],
                                   ["--direction", "BtoA", "--output_nc", "1"]])
def test_single_matches_jax(root, extra):
    argv = ["--model", "test", "--dataroot", str(root[0] / "trainA"), "--load_size", "36",
            "--crop_size", "32", "--seed", "5", *extra]
    cfg, jcfg = _both(argv, train_cfg=False)
    assert cfg.dataset_mode == jcfg.dataset_mode == "single"
    assert cfg.no_flip == jcfg.no_flip == ("--no-no_flip" not in extra)
    jax_loader, loader = jax_create_dataset(jcfg), create_dataset(cfg)
    jd, d = jax_loader.dataset, loader.dataset
    assert len(d) == len(jd) == 5
    for epoch in (0, 1):
        jd.epoch = d.epoch = epoch
        for i in range(len(d)):
            _same_sample(d[i], jd[i], ("A",))
    for want, got in zip(jax_loader, loader):
        _same_sample(got, want, ("A",))


@pytest.mark.parametrize("mode", ["unaligned", "single"])
def test_val_directories_match_jax(root, mode):
    for r, has_val in ((root[0], True), (root[1], False)):
        argv = ["--model", "cycle_gan", "--dataset_mode", mode, "--dataroot", str(r),
                "--load_size", "36", "--crop_size", "32", "--seed", "1"]
        cfg, jcfg = _both(argv)
        got, want = train.build_val_loader(cfg), jax_train_cli._build_val_loader(jcfg)
        if mode == "unaligned" and not has_val:
            assert got is None and want is None
            continue
        # unaligned: valA/ and valB/; single: every image under --dataroot
        assert got.num_samples == want.num_samples == (
            2 if mode == "unaligned" else 12 if has_val else 4)
        for w, g in zip(want, got):
            _same_sample(g, w, ("A", "B") if mode == "unaligned" else ("A",))


# ---------------------------------------------------------------------------
# images and pages
# ---------------------------------------------------------------------------


def _arrays():
    rng = np.random.default_rng(7)
    tanh = np.tanh(rng.normal(size=(2, 12, 20, 3)) * 2).astype(np.float32)
    field = (rng.normal(size=(1, 12, 20, 1)) * 4).astype(np.float32)
    gray = np.tanh(rng.normal(size=(12, 20, 1))).astype(np.float32)
    flat = np.tanh(rng.normal(size=(12, 20))).astype(np.float32)
    return {"tanh": tanh, "field": field, "gray": gray, "flat": flat}


@pytest.mark.parametrize("name", ["tanh", "field", "gray", "flat", "bf16"])
def test_tensor2im_matches_jax(name):
    x = _arrays().get(name)
    t = torch.from_numpy(_arrays()["tanh"]).bfloat16() if x is None else torch.from_numpy(x)
    want = jax_imaging.tensor2im(t.float().numpy())
    for got in (imaging.tensor2im(t), imaging.tensor2im(t.float().numpy())):
        assert got.dtype == np.uint8 and got.shape == (12, 20, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aspect", [1.0, 1.5, 0.6])
def test_save_image_and_pages_match_jax(tmp_path, aspect):
    img = jax_imaging.tensor2im(_arrays()["tanh"])
    pages = {}
    for who, mod, imod in (("jax", jax_html, jax_imaging), ("port", html, imaging)):
        web = tmp_path / who
        page = mod.HTML(str(web), "Experiment = e, Phase = test", refresh=3 if aspect > 1 else 0)
        imod.save_image(img, os.path.join(page.get_image_dir(), "x_fake.png"), aspect)
        page.add_header("x")
        page.add_images(["x_fake.png", "x_real.png"], ["fake", "real"],
                        ["x_fake.png", "x_real.png"], width=128)
        page.add_header("y")
        page.save()
        pages[who] = (np.asarray(Image.open(web / "images" / "x_fake.png")),
                      (web / "index.html").read_text())
    got, want = pages["port"], pages["jax"]
    h, w = img.shape[:2]
    assert got[0].shape[:2] == ((int(h * aspect), w) if aspect > 1 else
                                (h, int(w / aspect)) if aspect < 1 else (h, w))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_save_field_and_mkdirs_match_jax(tmp_path):
    field = torch.from_numpy(_arrays()["field"]).bfloat16()
    imaging.save_field(field, str(tmp_path / "port" / "f.npy"))
    jax_imaging.save_field(field.float().numpy(), str(tmp_path / "jax" / "f.npy"))
    got, want = np.load(tmp_path / "port" / "f.npy"), np.load(tmp_path / "jax" / "f.npy")
    assert got.dtype == np.float32 and got.shape == (1, 12, 20, 1)
    np.testing.assert_array_equal(got, want)
    imaging.mkdirs([str(tmp_path / "a" / "b"), str(tmp_path / "c")])
    imaging.mkdirs(str(tmp_path / "d"))
    assert all((tmp_path / d).is_dir() for d in ("a/b", "c", "d"))


def test_visualizer_matches_jax(tmp_path):
    """The loss line, loss_log.txt's lines, and the snapshot pages over two
    epochs and again from a new instance, whose row cache seeds from the
    images on disk (a resumed run)."""
    argv = ["--model", "pix2pix", "--dataset_mode", "synthetic", "--name", "vis"]
    arrays = _arrays()
    visuals = {"real_A": arrays["tanh"], "fake_B": arrays["field"], "real_B": arrays["gray"]}
    out = {}
    for who, cls in (("jax", JaxVisualizer), ("port", Visualizer)):
        ckpt = tmp_path / who
        cfg = (jax_parse_config if who == "jax" else parse_config)(
            argv + ["--checkpoints_dir", str(ckpt)], train=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            v = cls(cfg)
            v.print_current_losses(2, 8, {"G_GAN": 0.5, "G_L1": 1.25}, 0.01234, 0.5)
            v.display_current_results(visuals, 1)
            v.display_current_results({k: -x for k, x in visuals.items()}, 2)
            cls(cfg).display_current_results({k: x[..., :1] for k, x in visuals.items()}, 4)
        web = ckpt / "vis" / "web"
        out[who] = (buf.getvalue(), (ckpt / "vis" / "loss_log.txt").read_text(),
                    (web / "index.html").read_text(), sorted(os.listdir(web / "images")),
                    {f: np.asarray(Image.open(web / "images" / f))
                     for f in os.listdir(web / "images")})
    got, want = out["port"], out["jax"]
    assert got[0] == want[0] == ("(epoch: 2, iters: 8, time: 0.012, data: 0.500) G_GAN: 0.500 "
                                 "G_L1: 1.250\n")
    header = re.compile(r"^=+ Training Loss \(.*\) =+$")
    for g, w in zip(got[1].splitlines(), want[1].splitlines(), strict=True):
        assert (header.match(g) and header.match(w)) or g == w
    assert got[2] == want[2] and "epoch [4]" in got[2] and "epoch [1]" in got[2]
    assert got[3] == want[3] and len(got[3]) == 9
    for f in got[3]:
        np.testing.assert_array_equal(got[4][f], want[4][f])


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


def test_diagnostics_match_jax(capsys):
    from biasgan_tpu_torch.convert import state_dict_to_params
    from biasgan_tpu_torch.nn import define_G

    G = define_G("unet_d2", 1, 1, ngf=4, norm="batch",
                 generator=torch.Generator().manual_seed(0))
    params, stats = state_dict_to_params({k: v for k, v in G.state_dict().items()
                                          if not k.endswith("num_batches_tracked")})
    want = jax_diag.diagnose_network({"params": params, "batch_stats": stats}, "G")
    jax_out = capsys.readouterr().out
    got = diagnostics.diagnose_network(G, "G")
    out = capsys.readouterr().out
    assert out.splitlines()[0] == jax_out.splitlines()[0] == "G"
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert imaging.diagnose_network({"params": G.state_dict()}, "n") > 0
    assert diagnostics.diagnose_network({}, "empty") == 0.0
    assert capsys.readouterr().out.endswith("empty: <no arrays>\n")

    bad = {"a": np.array([1.0, np.nan, np.inf], np.float32), "b": np.ones(3, np.float32),
           "c": {"d": np.array([-np.inf], np.float32)}}
    tbad = {"a": torch.tensor([1.0, float("nan"), float("inf")]), "b": torch.ones(3),
            "c": {"d": torch.tensor([-float("inf")])}}
    assert diagnostics.count_nonfinite(tbad) == jax_diag.count_nonfinite(
        {k: jnp.asarray(v) if not isinstance(v, dict) else {"d": jnp.asarray(v["d"])}
         for k, v in bad.items()}) == {"a": 2, "b": 0, "c": 1}
    assert diagnostics.count_nonfinite(torch.ones(2)) == {"tree": 0}
    for where in ("", "step 3"):
        with pytest.raises(FloatingPointError) as want_e:
            jax_diag.assert_finite({"netG.params": {"w": jnp.asarray(bad["a"])}}, where)
        with pytest.raises(FloatingPointError) as got_e:
            diagnostics.assert_finite({"netG.params": {"w": tbad["a"]}}, where)
        assert str(got_e.value) == str(want_e.value)
    diagnostics.assert_finite({"netG.params": G})
    for losses in ({"G_GAN": float("nan"), "G_L1": 1.0},
                   {"G_GAN": float("inf"), "D_fake": float("nan")}):
        for where in ("", "epoch 1, iters 4"):
            with pytest.raises(FloatingPointError) as want_e:
                jax_diag.check_losses_finite(losses, where)
            with pytest.raises(FloatingPointError) as got_e:
                diagnostics.check_losses_finite(losses, where)
            assert str(got_e.value) == str(want_e.value)
    diagnostics.check_losses_finite({"G_L1": 1.0})


# ---------------------------------------------------------------------------
# CycleGAN at its default dataset
# ---------------------------------------------------------------------------


def test_cyclegan_trains_on_unaligned_by_default(root, tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train.main([
            "--model", "cycle_gan", "--dataroot", str(root[0]), "--netG", "resnet_2blocks",
            "--ngf", "4", "--ndf", "4", "--load_size", "36", "--crop_size", "32",
            "--pool_size", "2", "--n_epochs", "1", "--n_epochs_decay", "0",
            "--max_dataset_size", "1", "--print_freq", "1", "--device", "cpu",
            "--checkpoints_dir", str(tmp_path), "--name", "cg"])
    out = buf.getvalue()
    assert "dataset_mode: unaligned" in out and "The number of training images = 1" in out
    assert "The number of validation images = 1" in out  # valA/, capped too
    lines = [ln for ln in out.splitlines() if ln.startswith("(epoch: 1, iters: 1,")]
    assert len(lines) == 1 and "idt_B: " in lines[0]
    assert all(np.isfinite(float(v)) for v in re.findall(r": ([-0-9.]+)", lines[0].split(")")[1]))
    assert state.step == 1
