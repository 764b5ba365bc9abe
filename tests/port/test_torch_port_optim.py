"""The optimizer pieces of the PyTorch port against the JAX package: the
four LR policies of ``make_lr_schedule`` over the steps of several epochs,
and Adam (optax ``scale_by_adam`` with the learning rate applied by hand)
over five updates: the parameters and both moments at f32 rounding."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.models.common import adam_transform, apply_adam_update
from biasgan_tpu.models.common import make_lr_schedule as jax_schedule
from biasgan_tpu_torch.models.common import Adam, adam_of, make_lr_schedule


def _cfg(policy, **kw):
    base = dict(lr_policy=policy, lr=2e-4, steps_per_epoch=3, n_epochs=4, n_epochs_decay=3,
                epoch_count=1, lr_decay_iters=2)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("policy", ["linear", "step", "cosine", "plateau"])
@pytest.mark.parametrize("epoch_count", [1, 3])
def test_lr_schedules_match_jax(policy, epoch_count):
    cfg = _cfg(policy, epoch_count=epoch_count)
    want_fn, got_fn = jax_schedule(cfg), make_lr_schedule(cfg)
    for step in range(0, 25):
        for scale in (1.0, 0.2):
            want = float(want_fn(jnp.int32(step), jnp.float32(scale)))
            assert got_fn(step, scale) == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_unknown_policy_and_bf16_moments_refuse():
    with pytest.raises(ValueError, match="lr_policy"):
        make_lr_schedule(_cfg("exp"))
    with pytest.raises(NotImplementedError, match="not ported"):
        adam_of(SimpleNamespace(adam_mu_dtype="bfloat16", beta1=0.5), [])


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * (10.0 ** -i)
              for k, v in params.items()} for i in range(5)]
    tx = adam_transform(0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = Adam(list(tparams.items()), beta1=0.5)
    for i, g in enumerate(grads):
        lr = 2e-4 * (1 - 0.1 * i)
        jp, state = apply_adam_update(jp, jax.tree_util.tree_map(jnp.asarray, g), state, tx,
                                      jnp.float32(lr))
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step(lr)
    assert opt.count == int(state.count) == 5
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(opt.mu[k].numpy(), np.asarray(state.mu[k]), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(opt.nu[k].numpy(), np.asarray(state.nu[k]), rtol=1e-6,
                                   atol=1e-12)
