"""The port's validation metrics, held-out split and plateau policy against
the JAX package on the CPU.

* ``ops/metrics.py`` and ``ops/spectral.py`` against ``biasgan_tpu.ops``
  on the same fields (numpy, seeded): H < W, H > W, odd W, values on the
  bin edges and outside [lo, hi], a tanh range and a standardized one.
  Spectra at rtol 1e-4 (the JAX package's DFT matmuls against
  ``torch.fft``); rmse, bias and the log-spectral distance at rtol 1e-4;
  the PDFs and ``pdf_tv`` exact up to one count (1 / pixels).
* ``create_dataset``'s splits: the sizes, the held-out tail, the four
  errors (tests/unit/test_val_split.py:28-85), and a data rank's slices.
* The plateau rule (``models.base.plateau_update``) against
  ``biasgan_tpu.models.base.BaseModel.update_learning_rate`` driven on a
  small stub over a metric sequence that decays twice.
* CycleGAN's eval forwards, the held-out metrics' forward, against the
  JAX ``make_eval_fn``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.models.base import BaseModel
from biasgan_tpu.ops import metrics as jm
from biasgan_tpu.ops import spectral as js
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.data import create_dataset
from biasgan_tpu_torch.models.base import Plateau, plateau_update
from biasgan_tpu_torch.models.common import GANTrainState
from biasgan_tpu_torch.ops import metrics as tm
from biasgan_tpu_torch.ops import spectral as ts

SHAPES = [(2, 24, 40, 2), (2, 40, 24, 1), (1, 20, 37, 3)]  # H < W, H > W, odd W
RANGES = [(-1.0, 1.0), (-5.0, 5.0)]


def _fields(shape, lo, hi):
    """Two fields on ``shape``: normal values scaled to the range, with
    some pixels set exactly on bin edges and some outside [lo, hi]."""
    rng = np.random.default_rng(sum(shape))
    scale = (hi - lo) / 4
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    b = (rng.normal(size=shape) * scale * 1.3 + 0.1 * scale).astype(np.float32)
    edges = lo + (hi - lo) * np.arange(65, dtype=np.float32) / 64
    flat = a.reshape(-1)
    flat[:65] = edges
    flat[65:70] = [lo - 1.0, hi + 2.0, 3 * hi, 3 * lo, hi]
    return a, b


def _both(fn_j, fn_t, *xs, **kw):
    return (np.asarray(fn_j(*(jnp.asarray(x) for x in xs), **kw)),
            fn_t(*(torch.from_numpy(x) for x in xs), **kw).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=["h<w", "h>w", "odd_w"])
@pytest.mark.parametrize("rng_", RANGES, ids=["tanh", "standardized"])
def test_metrics_match_jax(shape, rng_):
    lo, hi = rng_
    a, b = _fields(shape, lo, hi)
    m = a.size // shape[-1]
    for name in ("zonal_power_spectrum", "radial_power_spectrum"):
        want, got = _both(getattr(js, name), getattr(ts, name), a)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=name)
    want, got = _both(jm.histogram_pdf, tm.histogram_pdf, a, lo=lo, hi=hi)
    assert got.shape == (64, shape[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / m + 1e-7, err_msg="pdf")
    np.testing.assert_allclose(got.sum(0), 1.0, rtol=1e-5)
    jv = jm.validation_metrics(jnp.asarray(a), jnp.asarray(b), lo, hi)
    tv = tm.validation_metrics(torch.from_numpy(a), torch.from_numpy(b), lo, hi)
    assert list(tv) == ["rmse", "bias", "pdf_tv", "log_spectral_distance"] == list(jv)
    for k in ("rmse", "log_spectral_distance"):
        np.testing.assert_allclose(float(tv[k]), float(jv[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(tv["bias"]), float(jv["bias"]), rtol=1e-4,
                               atol=1e-4 * float(jv["rmse"]), err_msg="bias")
    assert abs(float(tv["pdf_tv"]) - float(jv["pdf_tv"])) <= 1.0 / m + 1e-7


def test_bf16_fields_are_taken_in_f32():
    a, b = _fields(SHAPES[0], -1.0, 1.0)
    ab, bb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = tm.validation_metrics(ab, bb)
    want = tm.validation_metrics(ab.float(), bb.float())
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())


def test_spectra_of_known_fields():
    """A zonal wave of wavenumber 5 peaks at 5; a field's distance to
    itself is 0 (tests/unit/test_metrics.py)."""
    w = 64
    x = torch.sin(2 * torch.pi * 5 * torch.arange(w) / w)
    field = x.expand(2, 8, w)[..., None].contiguous()
    assert int(torch.argmax(ts.zonal_power_spectrum(field)[:, 0])) == 5
    a, _ = _fields(SHAPES[0], -1.0, 1.0)
    assert float(ts.log_spectral_distance(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


# ---------------------------------------------------------------------------
# the held-out split
# ---------------------------------------------------------------------------


def _cfg(extra=()):
    return parse_config(
        ["--model", "pix2pix", "--dataset_mode", "synthetic", "--netG", "unet_d4",
         "--crop_size", "32", "--input_nc", "1", "--output_nc", "1", "--batch_size", "2",
         "--ngf", "8", "--ndf", "8", "--synthetic_samples", "12", "--device", "cpu",
         *extra], train=True)


def _paths(loader):
    return [p for batch in loader for p in batch["A_paths"]]


def test_split_sizes_and_held_out_tail():
    cfg = _cfg(["--val_split", "4"])
    train, val = create_dataset(cfg, "train"), create_dataset(cfg, "val")
    assert (train.num_samples, val.num_samples, len(train), len(val)) == (8, 4, 4, 2)
    assert not set(_paths(train)) & set(_paths(val))
    assert set(_paths(val)) == {f"synthetic://{i}" for i in range(8, 12)}
    assert create_dataset(cfg).num_samples == 12  # split None ignores --val_split


def test_split_errors():
    with pytest.raises(ValueError, match="unknown split"):
        create_dataset(_cfg(["--val_split", "4"]), "valid")
    with pytest.raises(ValueError, match="val_split is not set"):
        create_dataset(_cfg(), "val")
    with pytest.raises(ValueError, match="must be smaller than the dataset"):
        create_dataset(_cfg(["--val_split", "12"]), "train")
    with pytest.raises(ValueError, match="batch_size"):
        create_dataset(_cfg(["--val_split", "1"]), "val")
    assert create_dataset(_cfg(["--val_split", "1"]), "train").num_samples == 11


def test_rank_loaders_slice_each_global_batch():
    """Two data ranks' loaders: each global batch, in the one-device order
    of the epoch, cut in two contiguous halves; a batch that does not
    split raises."""
    cfg = _cfg(["--batch_size", "4"])
    whole = create_dataset(cfg)
    ranks = [create_dataset(cfg, None, r, 2) for r in range(2)]
    for loader in (whole, *ranks):
        loader.epoch = 3
    for g, r0, r1 in zip(whole, *ranks):
        assert g["A_paths"] == r0["A_paths"] + r1["A_paths"]
        np.testing.assert_array_equal(g["A"], np.concatenate([r0["A"], r1["A"]]))
    assert all(len(r) == len(whole) == 3 for r in ranks)
    with pytest.raises(ValueError, match="--data_mesh 3"):
        create_dataset(cfg, None, 0, 3)


# ---------------------------------------------------------------------------
# the plateau policy
# ---------------------------------------------------------------------------


class _State:
    """The JAX state's one field the policy touches."""

    def __init__(self):
        self.lr_scale = jnp.ones((), jnp.float32)

    def replace(self, lr_scale):
        self.lr_scale = lr_scale
        return self


def test_plateau_matches_jax_update_learning_rate():
    stub = object.__new__(BaseModel)
    stub.cfg = _cfg(["--lr_policy", "plateau"])
    stub.state, stub._lr_fn, stub._epoch = _State(), None, 1
    stub._plateau_best, stub._plateau_bad = float("inf"), 0
    state = GANTrainState(step=0, lr_scale=1.0, nets={}, opts={})
    plateau = Plateau()
    # improves, then flat 6 epochs (one decay), a small gain below the 1%
    # threshold, then flat again (a second decay), then a real improvement
    metrics = ([1.0, 0.9] + [0.895] * 6 + [0.8915] + [0.9] * 6 + [0.5, 0.6] + [None])
    scales = []
    for m in metrics:
        stub.update_learning_rate(m)
        plateau_update(state, plateau, m)
        assert (plateau.best, plateau.bad) == (stub._plateau_best, stub._plateau_bad), m
        assert np.float32(state.lr_scale) == np.asarray(stub.state.lr_scale)
        scales.append(state.lr_scale)
    assert sorted(set(scales), reverse=True)[:3] == [1.0, float(np.float32(0.2)),
                                                     float(np.float32(0.2) ** 2)]


# ---------------------------------------------------------------------------
# CycleGAN's eval forwards (the held-out metrics' forward)
# ---------------------------------------------------------------------------


def test_cyclegan_eval_fn_matches_jax(tmp_path):
    """``models.cyclegan.make_eval_fn`` against the JAX ``make_eval_fn``
    (fake_B, rec_A, fake_A, rec_B) from the same weights, at 2e-4; the
    nets stay in training mode after it."""
    import jax

    from biasgan_tpu.config import parse_config as jax_parse_config
    from biasgan_tpu.models.common import init_state
    from biasgan_tpu.models.cyclegan import make_eval_fn as jax_make_eval_fn
    from biasgan_tpu_torch.convert import state_dict_to_params
    from biasgan_tpu_torch.models.cyclegan import create_state, make_eval_fn

    argv = ["--model", "cycle_gan", "--dataset_mode", "synthetic", "--netG", "resnet_3blocks",
            "--norm", "instance", "--no_dropout", "--crop_size", "32", "--input_nc", "1",
            "--output_nc", "1", "--ngf", "8", "--ndf", "8", "--no-in_graph_aug"]
    cfg = parse_config(argv + ["--device", "cpu"], train=True)
    state = create_state(cfg, torch.device("cpu"))
    nets = {k: {"params": jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_params(state.nets[k].state_dict())[0])}
        for k in ("G_A", "G_B")}
    jcfg = jax_parse_config(argv + ["--checkpoints_dir", str(tmp_path), "--name", "e"],
                            train=True)
    rng = np.random.default_rng(4)
    batch = {k: np.tanh(rng.normal(size=(2, 32, 32, 1))).astype(np.float32) for k in "AB"}
    want = jax_make_eval_fn(jcfg)(init_state(nets, {}), {k: jnp.asarray(v) for k, v in
                                                          batch.items()},
                                  jax.random.PRNGKey(0), train=False)
    got = make_eval_fn(cfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    assert all(net.training for net in state.nets.values())
