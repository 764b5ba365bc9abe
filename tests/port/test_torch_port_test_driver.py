"""The port's test driver (``python -m biasgan_tpu_torch.test``), its models
and the training loop's observability flags, on the CPU, against the JAX
package where it has a counterpart.

* The G forwards the test driver runs, from a checkpoint of seeded weights
  whose batch-norm running averages have moved (unet_d3, ngf 4, 32x32, one
  channel, f32, dropout off so both sides are deterministic): ``--model
  test --model_suffix _A`` against the JAX ``TestModel``'s eval function
  (also with ``--netG_activation none``: the JAX TestModel ends in tanh
  whatever the flag says), pix2pix and template against the JAX
  ``make_eval_fn``s, each with --eval (running averages) and without
  (batch statistics), within 1e-5 (rtol and atol); G's running averages
  bitwise unchanged after the training-mode forward (JAX drops their
  update).
* One template training step against the JAX ``make_train_step`` (unet_d4
  batch norm, ngf 8, batch 2, 32x32): the loss at rtol 2e-4, Adam's
  moments and the parameters by the pix2pix tests' rules, the running
  averages at rtol 1e-3.
* ``biasgan_tpu_torch.test.main`` in this process on a tiny unet_d4
  pix2pix run trained one step on an aligned PNG dataset: the page, its
  rows and images, each fake_B PNG within one grey level of JAX
  ``tensor2im`` of the JAX eval function's output (with and without
  --eval), and the SystemExit naming a missing checkpoint.
* The training loop: --display_freq pages across a resume, --check_finite
  raising on a loss made non-finite (and on a parameter), --debug_nans
  (anomaly mode for the run, restored after), --profile (a trace of steps
  10-20).
"""

import contextlib
import io
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.models.common import adam_transform_of, init_state
from biasgan_tpu.models.pix2pix import make_eval_fn as jax_p2p_eval_fn
from biasgan_tpu.models.template import make_eval_fn as jax_template_eval_fn
from biasgan_tpu.models.template import make_train_step as jax_template_step
from biasgan_tpu.models.test_model import TestModel as JaxTestModel
from biasgan_tpu.utils.imaging import tensor2im as jax_tensor2im
from biasgan_tpu_torch import test as driver
from biasgan_tpu_torch import train
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.models import template
from biasgan_tpu_torch.models.common import generator_of
from biasgan_tpu_torch.registry import get_model
from biasgan_tpu_torch.utils import checkpoint

S, TOL = 32, 1e-5
G_ARGS = ["--netG", "unet_d3", "--ngf", "4", "--norm", "batch", "--no_dropout",
          "--input_nc", "1", "--output_nc", "1", "--crop_size", str(S)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread (tests/port/test_torch_port_pix2pix.py: after
    JAX has run in the process, torch's thread pool contends with JAX's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jax_vars(net):
    params, stats = jax.tree_util.tree_map(jnp.asarray, state_dict_to_params(
        {k: v for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}))
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def _buffers(net):
    return {k: v.clone() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A run directory holding one seeded unet_d3 G, its running averages
    moved by three training-mode forwards, as the pix2pix / template net
    ``G`` and as a CycleGAN run's ``G_A``."""
    root = tmp_path_factory.mktemp("driver_ckpt")
    cfg = parse_config(["--model", "pix2pix"] + G_ARGS)
    G = generator_of(cfg, 1, 1, generator=torch.Generator().manual_seed(0)).train()
    with torch.no_grad():
        for i in range(3):
            G(torch.randn(2, S, S, 1, generator=torch.Generator().manual_seed(i)))
    for name in ("G", "G_A"):
        checkpoint.save_network(G, str(root / "run"), "latest", name)
    return root


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {k: np.tanh(rng.normal(size=(2, S, S, 1))).astype(np.float32) for k in "AB"}


def _port_eval(ckpt, model, extra, batch, train_mode):
    """The test driver's state and forward on the CPU: (visuals as numpy, G's
    buffers before, after)."""
    cfg = parse_config(["--model", model, "--checkpoints_dir", str(ckpt), "--name", "run",
                        "--device", "cpu"] + G_ARGS + extra)
    state = driver.build_state(cfg, torch.device("cpu"), say=lambda _: None)
    (G,) = state.nets.values()
    before = _buffers(G)
    visuals = get_model(model).make_eval_fn(cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, train=train_mode)
    return {k: v.numpy() for k, v in visuals.items()}, before, _buffers(G), G


def _jax_cfg(ckpt, model, extra):
    return jax_parse_config(["--model", model, "--checkpoints_dir", str(ckpt), "--name", "j"]
                            + G_ARGS + extra, train=False)


@pytest.mark.parametrize("train_mode", [True, False], ids=["train_mode", "eval"])
@pytest.mark.parametrize("act", ["tanh", "none"])
def test_test_model_suffix_matches_jax(ckpt, train_mode, act):
    """--model test --model_suffix _A: the CycleGAN run's G_A in the one G
    slot, ending in tanh as the JAX TestModel's G does whatever
    --netG_activation says."""
    extra = ["--model_suffix", "_A", "--netG_activation", act]
    batch = _batch()
    got, before, after, G = _port_eval(ckpt, "test", extra, batch, train_mode)
    assert G.out_activation == "tanh"
    stub = types.SimpleNamespace(cfg=_jax_cfg(ckpt, "test", extra))
    stub._build_g = lambda: JaxTestModel._build_g(stub)
    want = JaxTestModel._make_eval_fn(stub)(
        init_state({"G": _jax_vars(G)}, {}), {"A": jnp.asarray(batch["A"])},
        jax.random.PRNGKey(0), train=train_mode)
    assert sorted(got) == sorted(want) == ["fake", "real"]
    np.testing.assert_array_equal(got["real"], batch["A"])
    np.testing.assert_allclose(got["fake"], np.asarray(want["fake"]), rtol=TOL, atol=TOL)
    assert all(torch.equal(after[k], v) for k, v in before.items())


@pytest.mark.parametrize("train_mode", [True, False], ids=["train_mode", "eval"])
@pytest.mark.parametrize("model", ["pix2pix", "template"])
def test_eval_fns_match_jax(ckpt, model, train_mode):
    batch = _batch(4)
    got, before, after, G = _port_eval(ckpt, model, [], batch, train_mode)
    jax_fn = jax_p2p_eval_fn if model == "pix2pix" else jax_template_eval_fn
    want = jax_fn(_jax_cfg(ckpt, model, []))(
        init_state({"G": _jax_vars(G)}, {}), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), train=train_mode)
    assert sorted(got) == sorted(want) == ["fake_B", "real_A", "real_B"]
    np.testing.assert_allclose(got["fake_B"], np.asarray(want["fake_B"]), rtol=TOL, atol=TOL)
    # the running averages stay bitwise as they were, and they differ from
    # the batch statistics the training-mode forward used
    assert all(torch.equal(after[k], v) for k, v in before.items())
    other, *_ = _port_eval(ckpt, model, [], batch, not train_mode)
    assert np.abs(other["fake_B"] - got["fake_B"]).max() > 1e-3


def test_cyclegan_test_forward_leaves_running_averages(ckpt):
    """CycleGAN's four test forwards with batch-norm Gs in training mode:
    the Gs' running averages bitwise as they were."""
    from biasgan_tpu_torch.models.cyclegan import make_eval_fn

    cfg = parse_config(["--model", "cycle_gan", "--device", "cpu"] + G_ARGS)
    nets = {k: generator_of(cfg, 1, 1, generator=torch.Generator().manual_seed(i))
            for i, k in enumerate(("G_A", "G_B"))}
    state = types.SimpleNamespace(nets=nets, step=0)
    before = {k: _buffers(g) for k, g in nets.items()}
    out = make_eval_fn(cfg)(state, {k: torch.from_numpy(v) for k, v in _batch().items()},
                            train=True)
    assert sorted(out) == ["fake_A", "fake_B", "real_A", "real_B", "rec_A", "rec_B"]
    for k, g in nets.items():
        assert all(torch.equal(v, before[k][n]) for n, v in g.state_dict().items()), k


# ---------------------------------------------------------------------------
# the template model's step
# ---------------------------------------------------------------------------


def test_template_step_matches_jax(tmp_path):
    argv = ["--model", "template", "--dataset_mode", "synthetic", "--netG", "unet_d4",
            "--norm", "batch", "--no_dropout", "--ngf", "8", "--input_nc", "1",
            "--output_nc", "1", "--crop_size", str(S), "--batch_size", "2",
            "--lambda_regression", "2.5", "--n_epochs", "1", "--n_epochs_decay", "1",
            "--checkpoints_dir", str(tmp_path), "--name", "t"]
    cfg = parse_config(argv + ["--device", "cpu"], train=True)
    jcfg = jax_parse_config(argv, train=True)
    cfg.steps_per_epoch = jcfg.steps_per_epoch = 2
    state = template.create_state(cfg, torch.device("cpu"))
    G = state.nets["G"]
    gvars = _jax_vars(G)
    jstate = init_state({"G": gvars}, {"G": (adam_transform_of(jcfg), gvars["params"])})
    batch = _batch(5)
    jstate, jl, _ = jax.jit(jax_template_step(jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    tl, tv = template.make_train_step(cfg)(state, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    assert list(tl) == ["G_L1"] and sorted(tv) == ["fake_B", "real_A", "real_B"]
    np.testing.assert_allclose(float(tl["G_L1"]), float(jl["G_L1"]), rtol=2e-4)
    assert state.step == int(jstate.step) == 1 and state.opts["G"].count == 1

    def sd(tree, stats=None):
        return {k: v.numpy() for k, v in params_to_state_dict(tree, stats).items()
                if not k.endswith("num_batches_tracked")}

    for moment in ("mu", "nu"):
        got = {k.split(".", 1)[1]: v.numpy() for k, v in getattr(state.opts["G"],
                                                                 moment).items()}
        want = sd(getattr(jstate.opts["G"], moment))
        atol = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=atol, err_msg=f"{moment} {k}")
    v = jstate.nets["G"]
    want = sd(v["params"], v["batch_stats"])
    got = {k: t.numpy() for k, t in G.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    stats = [k for k in want if "running" in k]
    assert stats and int(G.down_norms["1"].num_batches_tracked) == 1
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
    lr = cfg.lr
    for k in (k for k in want if k not in stats):
        d = np.abs(got[k] - want[k])
        assert d.max() <= 6 * lr, f"params {k}: {d.max()}"
        assert float(np.mean(d > 1e-3 * np.abs(want[k]) + 1e-7)) <= 0.005, k


def test_template_refuses_spatial_mesh():
    cfg = parse_config(["--model", "template", "--spatial_mesh", "2"], train=True)
    with pytest.raises(NotImplementedError, match="template"):
        template.make_train_step(cfg, ctx=object())
    with pytest.raises(NotImplementedError, match="spatially sharded"):
        train.main(["--model", "template", "--dataset_mode", "synthetic", "--netG", "unet_d2",
                    "--spatial_mesh", "2", "--w_pad_mode", "wrap", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the test driver
# ---------------------------------------------------------------------------

P2P = ["--model", "pix2pix", "--netG", "unet_d4", "--ngf", "8", "--norm", "batch",
       "--input_nc", "1", "--output_nc", "1", "--load_size", str(S), "--crop_size", str(S),
       "--device", "cpu"]


@pytest.fixture(scope="module")
def p2p_run(tmp_path_factory):
    """An aligned dataset of two A|B PNGs in train/ and test/, and a
    pix2pix run trained on it for one step."""
    root = tmp_path_factory.mktemp("driver_run")
    rng = np.random.default_rng(2)
    for phase in ("train", "test"):
        (root / "data" / phase).mkdir(parents=True)
        for i in range(2):
            ab = rng.integers(0, 256, size=(S, 2 * S, 3), dtype=np.uint8)
            Image.fromarray(ab).save(root / "data" / phase / f"{phase}{i}.png")
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(P2P + ["--dataroot", str(root / "data"), "--max_dataset_size", "1",
                          "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq",
                          "1", "--checkpoints_dir", str(root / "ck"), "--name", "p2p"])
    return root


@pytest.mark.parametrize("eval_mode", [False, True], ids=["train_mode", "eval"])
def test_driver_writes_pages_matching_jax(p2p_run, eval_mode, capsys):
    argv = P2P + ["--dataroot", str(p2p_run / "data"), "--checkpoints_dir",
                  str(p2p_run / "ck"), "--name", "p2p", "--results_dir",
                  str(p2p_run / f"res_{eval_mode}")] + (["--eval"] if eval_mode else [])
    web_dir = driver.main(argv)
    out = capsys.readouterr().out
    assert web_dir == str(p2p_run / f"res_{eval_mode}" / "p2p" / "test_latest")
    assert "loaded net G from" in out and f"eval: {eval_mode}" in out
    assert re.search(r"processing \(0000\)-th image\.\.\. \['.*test0\.png'\] \(forward "
                     r"[0-9.]+ ms\)", out)
    page = open(os.path.join(web_dir, "index.html")).read()
    assert page.startswith("<!DOCTYPE html><html><head><title>Experiment = p2p, Phase = test, "
                           "Epoch = latest</title></head><body><h3>test0</h3>")
    names = [f"test{i}_{k}.png" for i in range(2) for k in ("real_A", "fake_B", "real_B")]
    assert sorted(os.listdir(os.path.join(web_dir, "images"))) == sorted(names)
    assert all(f'<img src="images/{n}"' in page for n in names)

    # JAX: its dataset's arrays through its eval function on the same G
    from biasgan_tpu.data import create_dataset as jax_create_dataset

    jcfg = jax_parse_config([a for a in argv if a not in ("--device", "cpu")], train=False)
    cfg = parse_config(argv)
    G = driver.build_state(cfg, torch.device("cpu"), say=lambda _: None).nets["G"]
    eval_fn = jax_p2p_eval_fn(jcfg)
    state = init_state({"G": _jax_vars(G)}, {})
    for i, data in enumerate(jax_create_dataset(jcfg)):
        batch = {k: jnp.asarray(v) for k, v in data.items() if not k.endswith("_paths")}
        want = jax_tensor2im(np.asarray(eval_fn(state, batch, jax.random.PRNGKey(0),
                                                train=not eval_mode)["fake_B"]))
        got = np.asarray(Image.open(os.path.join(web_dir, "images", f"test{i}_fake_B.png")))
        assert got.shape == want.shape == (S, S, 3)
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_driver_missing_checkpoint_exits(p2p_run):
    with pytest.raises(SystemExit, match=r"no checkpoint 'latest' under .*nope \(.*nope/"
                                         r"latest_net_G\.pth is missing\)"):
        driver.main(P2P + ["--dataroot", str(p2p_run / "data"), "--checkpoints_dir",
                           str(p2p_run / "ck"), "--name", "nope"])
    with pytest.raises(SystemExit, match=r"epoch_1_net_G_A\.pth is missing"):
        driver.main(["--model", "test", "--model_suffix", "_A", "--dataroot",
                     str(p2p_run / "data"), "--checkpoints_dir", str(p2p_run / "ck"),
                     "--name", "p2p", "--epoch", "epoch_1", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the training loop's flags
# ---------------------------------------------------------------------------

TINY = ["--model", "template", "--dataset_mode", "synthetic", "--netG", "unet_d2",
        "--ngf", "2", "--input_nc", "1", "--output_nc", "1", "--crop_size", "16",
        "--no_dropout", "--n_epochs", "1", "--n_epochs_decay", "0", "--print_freq", "1",
        "--device", "cpu"]


def _train(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train.main(argv)
    return state, buf.getvalue()


def test_display_pages_across_resume(tmp_path):
    base = TINY + ["--synthetic_samples", "2", "--display_freq", "2", "--save_epoch_freq",
                   "1", "--checkpoints_dir", str(tmp_path), "--name", "d", "--lr_policy",
                   "step"]
    _train(base)
    _train(base + ["--continue_train", "--epoch", "epoch_1", "--epoch_count", "2",
                   "--n_epochs", "2"])
    web = tmp_path / "d" / "web"
    page = (web / "index.html").read_text()
    assert page.index("<h3>epoch [2]</h3>") < page.index("<h3>epoch [1]</h3>")
    assert sorted(os.listdir(web / "images")) == sorted(
        f"epoch00{e}_{k}.png" for e in (1, 2) for k in ("real_A", "fake_B", "real_B"))
    log = (tmp_path / "d" / "loss_log.txt").read_text().splitlines()
    assert sum(ln.startswith("================ Training Loss") for ln in log) == 2
    assert re.findall(r"\(epoch: (\d+), iters: (\d+),", "\n".join(log)) == [
        ("1", "1"), ("1", "2"), ("2", "3"), ("2", "4")]


def test_check_finite_raises(tmp_path, monkeypatch):
    real_batch_to, calls = train.batch_to, []

    def nan_on_second(data, device):
        calls.append(1)
        out = real_batch_to(data, device)
        if len(calls) == 2:
            out["A"] = out["A"] * float("nan")
        return out

    monkeypatch.setattr(train, "batch_to", nan_on_second)
    with pytest.raises(FloatingPointError, match=r"non-finite loss \['G_L1'\] at epoch 1, "
                                                 r"iters 2 — a NaN/Inf"):
        _train(TINY + ["--synthetic_samples", "3", "--check_finite", "2",
                       "--checkpoints_dir", str(tmp_path), "--name", "c"])
    state = types.SimpleNamespace(nets={"G": torch.nn.Linear(2, 2)})
    with torch.no_grad():
        state.nets["G"].weight[0, 0] = float("inf")
    with pytest.raises(FloatingPointError, match=r"non-finite values \{'netG.params': 1\} "
                                                 r"in epoch 3, iters 9"):
        train.check_finite(state, {"G_L1": torch.tensor(1.0)}, "epoch 3, iters 9",
                           params=True)


def test_debug_nans_and_profile(tmp_path, monkeypatch):
    """--debug_nans: anomaly mode for the run (a NaN from the backward
    raises, naming its op), restored after; --profile: the trace of steps
    10-20 written and its path printed."""
    base = TINY + ["--checkpoints_dir", str(tmp_path)]
    state, out = _train(base + ["--synthetic_samples", "21", "--profile", "--name", "p",
                                "--print_freq", "100"])
    path = tmp_path / "p" / "profile" / "trace.json"
    assert f"profile trace written to {path}" in out and path.stat().st_size > 0
    assert state.step == 21

    real_batch_to = train.batch_to
    monkeypatch.setattr(train, "batch_to", lambda d, dev: {
        k: v * float("nan") for k, v in real_batch_to(d, dev).items()})
    with pytest.raises(RuntimeError, match="returned nan values"):
        _train(base + ["--synthetic_samples", "1", "--debug_nans", "--name", "n"])
    assert not torch.is_anomaly_enabled()
    _, out = _train(base + ["--synthetic_samples", "1", "--name", "m"])
    assert "G_L1: nan" in out
