"""--adam_mu_dtype bfloat16 in the port: Adam with a bf16 first moment
against optax ``scale_by_adam(mu_dtype=bfloat16)``, on the CPU.

- Ten updates from the same numpy grads (spanning four decades): the
  stored first moment bitwise optax's, the second moment and each
  update (the direction, read with lr 1 from a zeroed parameter) within
  1e-6 relative of the tree's largest |value|.
- The five-step pix2pix trajectory of tests/unit/test_adam_mu_bf16.py
  (unet_d4, ngf / ndf 8, 32x32, batch 2, instance norm, no dropout, one
  batch; no augmentation, so no draw enters), port against JAX from the
  same weights (the port's seeded nets, converted), both with the bf16
  moment, at that file's bounds: the last step's losses rtol / atol 2e-2,
  the parameters atol 2e-3 (5 steps x 2 lr: a near-zero grad whose bf16
  moment flips sign moves its parameter by up to 2 lr a step); the same
  bounds hold the port's bf16 run to its f32 run, and every stored first
  moment is bf16.
- A checkpoint round trip (``utils.checkpoint``) keeps the first moment in
  bf16, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.models.common import adam_transform
from biasgan_tpu.models.pix2pix import make_train_step as jax_make_train_step
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.models.common import Adam
from biasgan_tpu_torch.models.pix2pix import create_state, make_train_step
from biasgan_tpu_torch.utils import checkpoint
from test_torch_port_pix2pix import _sd, jax_state_of

ARGS = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--netG", "unet_d4",
    "--crop_size", "32", "--input_nc", "1", "--output_nc", "1", "--batch_size", "2",
    "--ngf", "8", "--ndf", "8", "--norm", "instance", "--no_dropout", "--no-in_graph_aug",
]
STEPS, BOUND, PARAM_ATOL = 5, 2e-2, 2e-3


def test_bf16_moment_matches_optax():
    rng = np.random.default_rng(0)
    shapes = {"a": (40, 30), "b": (50,), "c": (3, 3, 8, 8)}
    grads = [{k: (rng.normal(size=s) * 10.0 ** -(i % 4)).astype(np.float32)
              for k, s in shapes.items()} for i in range(10)]
    tx = adam_transform(0.5, mu_dtype=jnp.bfloat16)
    jstate = tx.init({k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()})
    update = jax.jit(tx.update)
    params = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in shapes.items()}
    opt = Adam(list(params.items()), beta1=0.5, mu_dtype=torch.bfloat16)
    for i, g in enumerate(grads):
        ups, jstate = update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
            p.data.zero_()
        opt.step(1.0)  # from zero at lr 1 the parameter is minus the update
        for k in shapes:
            assert opt.mu[k].dtype == torch.bfloat16 and jstate.mu[k].dtype == jnp.bfloat16
            want = np.asarray(jstate.mu[k].astype(jnp.float32))
            np.testing.assert_array_equal(opt.mu[k].float().numpy(), want,
                                          err_msg=f"update {i + 1} mu {k}")
            for got, ref, what in ((opt.nu[k].numpy(), np.asarray(jstate.nu[k]), "nu"),
                                   (-params[k].detach().numpy(), np.asarray(ups[k]), "update")):
                atol = 1e-6 * float(np.abs(ref).max())
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol,
                                           err_msg=f"update {i + 1} {what} {k}")
    assert opt.count == int(jstate.count) == 10


def _port_run(mu_dtype, before=None):
    """Five port steps on one batch from the seeded state; ``before(cfg,
    state)`` sees the state first. Returns (state, last losses, batch)."""
    cfg = parse_config(ARGS + ["--adam_mu_dtype", mu_dtype, "--device", "cpu"], train=True)
    cfg.steps_per_epoch = 4
    state = create_state(cfg, torch.device("cpu"))
    if before is not None:
        before(cfg, state)
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    batch = {"A": a, "B": np.tanh(a)}
    step = make_train_step(cfg)
    for _ in range(STEPS):
        losses, _ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in losses.items()}, batch


def _nets(state):
    return {net: {k: t.detach().numpy() for k, t in m.state_dict().items()}
            for net, m in state.nets.items()}


def test_bf16_trajectory_matches_jax_and_f32(tmp_path):
    jcfg = jax_parse_config(ARGS + ["--adam_mu_dtype", "bfloat16", "--checkpoints_dir",
                                    str(tmp_path), "--name", "mu"], train=True)
    jcfg.steps_per_epoch = 4
    start = {}
    state, losses, batch = _port_run(
        "bfloat16", lambda cfg, st: start.update(jstate=jax_state_of(st, jcfg)))
    jstate = start["jstate"]
    assert all(t.dtype == torch.bfloat16 for o in state.opts.values() for t in o.mu.values())
    jstep = jax.jit(jax_make_train_step(jcfg))
    for i in range(STEPS):
        jstate, jl, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.fold_in(jax.random.PRNGKey(2), i))
    assert any(x.dtype == jnp.bfloat16 for x in jax.tree_util.tree_leaves(jstate.opts["G"]))
    f32, l32, _ = _port_run("float32")
    got = _nets(state)
    for what, want_l, want_nets in (
            ("JAX bf16", {k: float(v) for k, v in jl.items()},
             {n: _sd(v["params"], v.get("batch_stats")) for n, v in jstate.nets.items()}),
            ("port f32", l32, _nets(f32))):
        for k, v in want_l.items():
            np.testing.assert_allclose(losses[k], v, rtol=BOUND, atol=BOUND,
                                       err_msg=f"vs {what}: loss {k}")
        for net, sd in want_nets.items():
            for k, v in sd.items():
                if not k.endswith("num_batches_tracked"):
                    np.testing.assert_allclose(got[net][k], v, rtol=0, atol=PARAM_ATOL,
                                               err_msg=f"vs {what}: {net}.{k}")


def test_bf16_moment_checkpoint_round_trip(tmp_path):
    state, _, _ = _port_run("bfloat16")
    checkpoint.save_state(str(tmp_path), "latest", state, {"host_step": STEPS})
    cfg = parse_config(ARGS + ["--adam_mu_dtype", "bfloat16", "--device", "cpu"], train=True)
    fresh = create_state(cfg, torch.device("cpu"))
    assert checkpoint.load_state(str(tmp_path), "latest", fresh) == {"host_step": STEPS}
    assert fresh.step == state.step == STEPS
    for name, opt in state.opts.items():
        assert fresh.opts[name].count == opt.count == STEPS
        for k, t in opt.mu.items():
            got = fresh.opts[name].mu[k]
            assert got.dtype == t.dtype == torch.bfloat16 and torch.equal(got, t), k
            assert torch.equal(fresh.opts[name].nu[k], opt.nu[k]), k
