"""The pix2pix training step of the PyTorch port against the JAX
``make_train_step(debug_grad_norms=True)``: the same weights (JAX's,
converted), the same batches, three steps, f32, unet_d4 G and basic D at
ngf / ndf 8, 64x64, batch 2, no dropout and no augmentation (the two
packages' random streams cannot be matched). For wgangp the penalty's
alpha is JAX's own, rebuilt from the step key (``jax.random.split(rng)[1]``,
then ``uniform((B, 1, 1, 1))``), and handed to the port's step. Cases: batch
norm under vanilla, lsgan and wgangp (D's fake and real passes apart, its
running averages moved three times a step and not by the penalty's pass),
and instance norm under vanilla (the one 2B D pass).

Held: each step's losses at rtol 2e-4 (as the CycleGAN step,
test_torch_port_cyclegan.py); the global
gradient norms at rtol 1e-3; Adam's first moment after step 1, (1 - b1) g,
leaf by leaf at rtol 1e-3 and 1e-3 of the tree's largest |value| (a bias
ahead of an instance norm has a zero gradient in exact arithmetic, so its
own scale is rounding noise); after three steps the running averages of G
and D at rtol 1e-3 and 1e-4 of the tree's largest |value|; the parameters
within 6 lr everywhere (three Adam steps move a parameter by about lr each
whatever its gradient's size, so that is as far apart as they can go) and
within rtol 1e-3 and 1e-5 of the tree's largest |value| at all but 0.5% of
each leaf's elements (Adam divides each gradient by its own scale, so an
element whose gradient is small at steps 2 and 3 carries the gradients'
rounding differences into its update at full size), except under instance
norm the biases ahead of a norm, whose gradient is all rounding noise:
those within 6 lr only; and an eval-mode G forward at 2e-4 beside the JAX
G's. (A run holding every parameter elementwise at rtol 1e-3 and 1e-5 of
the largest |value| failed 3 of the 8192 elements of one leaf, by up to
4.2e-5: what the 0.5% rule is for.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.models.common import adam_transform_of, init_state
from biasgan_tpu.models.pix2pix import Pix2PixModel as JaxPix2Pix
from biasgan_tpu.models.pix2pix import build_nets as jax_build_nets
from biasgan_tpu.models.pix2pix import make_train_step as jax_make_train_step
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.models.pix2pix import create_state, make_train_step

B, S, K, LR = 2, 64, 3, 2e-4
ARGS = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--netG", "unet_d4",
    "--crop_size", str(S), "--input_nc", "1", "--output_nc", "1", "--batch_size", str(B),
    "--ngf", "8", "--ndf", "8", "--no_dropout", "--no-in_graph_aug", "--lr", str(LR),
    "--n_epochs", "1", "--n_epochs_decay", "1",
]


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

# unet_d4's and the basic D's conv biases that an instance norm follows
NORMED_BIASES = {"G": ["downs.1.bias", "downs.2.bias", "ups.1.bias", "ups.2.bias",
                       "ups.3.bias"],
                 "D": ["convs.1.bias", "convs.2.bias", "convs.3.bias"]}


def _sd(tree, stats=None):
    """A JAX tree (and its batch stats) under the port's state_dict names,
    as numpy."""
    return {k: v.numpy() for k, v in params_to_state_dict(tree, stats).items()
            if not k.endswith("num_batches_tracked")}


def jax_state_of(state, jcfg):
    """The JAX train state of the port's freshly built nets: their weights
    and running averages converted, fresh Adam states (flax's own init of
    the same nets, not jitted, takes ~20 s on this CPU)."""
    nets, opt_map = {}, {}
    tx = adam_transform_of(jcfg)
    for name, net in state.nets.items():
        params, stats = jax.tree_util.tree_map(jnp.asarray, state_dict_to_params(
            {k: v for k, v in net.state_dict().items()
             if not k.endswith("num_batches_tracked")}))
        nets[name] = {"params": params, **({"batch_stats": stats} if stats else {})}
        opt_map[name] = (tx, params)
    return init_state(nets, opt_map)


def _close(got, want, rtol, atol_frac, what, atol_add=0.0):
    """Leaf by leaf, within rtol and atol_frac of the largest |value| of
    the whole tree, plus ``atol_add``."""
    assert sorted(got) == sorted(want), what
    atol = atol_frac * max(float(np.abs(v).max()) for v in want.values()) + atol_add
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("norm,gan_mode", [("batch", "vanilla"), ("batch", "lsgan"),
                                           ("batch", "wgangp"), ("instance", "vanilla")])
def test_pix2pix_steps_match_jax(norm, gan_mode, tmp_path):
    argv = ARGS + ["--norm", norm, "--gan_mode", gan_mode,
                   "--checkpoints_dir", str(tmp_path), "--name", "p"]
    jcfg = jax_parse_config(argv, train=True)
    cfg = parse_config(argv + ["--device", "cpu"], train=True)
    jcfg.steps_per_epoch = cfg.steps_per_epoch = 2
    state = create_state(cfg, torch.device("cpu"))
    jstate = jax_state_of(state, jcfg)
    jstep = jax.jit(jax_make_train_step(jcfg, debug_grad_norms=True))
    step = make_train_step(cfg, debug_grad_norms=True)

    rng = np.random.default_rng(1)
    for i in range(K):
        a = np.tanh(rng.normal(size=(B, S, S, 1))).astype(np.float32)
        b = np.tanh(rng.normal(size=(B, S, S, 1))).astype(np.float32)
        key = jax.random.PRNGKey(2 + i)
        alpha = jax.random.uniform(jax.random.split(key)[1], (B, 1, 1, 1))
        jstate, jl, _ = jstep(jstate, {"A": jnp.asarray(a), "B": jnp.asarray(b)}, key)
        tl, tv = step(state, {"A": torch.from_numpy(a), "B": torch.from_numpy(b)},
                      gp_alpha=torch.from_numpy(np.array(alpha)))
        assert list(tl) == JaxPix2Pix.loss_names + ["g_grad_norm", "d_grad_norm"]
        for k in JaxPix2Pix.loss_names:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=2e-4, atol=1e-6,
                                       err_msg=f"step {i + 1} loss {k}")
        for k in ("g_grad_norm", "d_grad_norm"):
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-3,
                                       err_msg=f"step {i + 1} {k}")
        if i == 0:
            for net in ("G", "D"):
                mu = {k.split(".", 1)[1]: v.numpy() for k, v in state.opts[net].mu.items()}
                _close(mu, _sd(jstate.opts[net].mu), 1e-3, 1e-3, f"step-1 {net} Adam mu")
    assert state.step == int(jstate.step) == K
    for net in ("G", "D"):
        v = jstate.nets[net]
        want = _sd(v["params"], v.get("batch_stats"))
        got = {k: t.numpy() for k, t in state.nets[net].state_dict().items()
               if not k.endswith("num_batches_tracked")}
        stats = [k for k in want if "running" in k]
        assert bool(stats) == (norm == "batch")
        if stats:
            _close({k: got[k] for k in stats}, {k: want[k] for k in stats}, 1e-3, 1e-4,
                   f"{net} running averages")
        noise = NORMED_BIASES[net] if norm == "instance" else ()
        params = [k for k in want if k not in stats]
        atol = 1e-5 * max(float(np.abs(want[k]).max()) for k in params)
        for k in params:
            d = np.abs(got[k] - want[k])
            assert d.max() <= 6 * LR, f"{net} params {k}: {d.max()}"
            off = float(np.mean(d > 1e-3 * np.abs(want[k]) + atol))
            assert k in noise or off <= 0.005, f"{net} params {k}: {off:.2%} off"
    x = np.tanh(rng.normal(size=(1, S, S, 1))).astype(np.float32)
    G, _ = jax_build_nets(jcfg)
    want = np.asarray(jax.jit(lambda v, x: G.apply(v, x, False))(jstate.nets["G"],
                                                                 jnp.asarray(x)))
    with torch.no_grad():
        got = state.nets["G"].eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
