"""The pix2pix nets' parts of the PyTorch port against the JAX package, on
the CPU at tiny shapes, f32 unless said:

* batch norm (``nn.layers.BatchNorm``) against ``biasgan_tpu.nn.layers.Norm
  ('batch')`` (flax BatchNorm), in training and in eval, with an f32 and a
  bf16 output: the outputs, the gradients of the input, scale and bias, and
  the running averages after three training calls; outputs and gradients at
  rtol / atol 1e-5 (f32) or one bf16 ulp of the output (bf16), running
  averages at 1e-6;
* the U-Net (``UNetGenerator``) against the JAX ``UNetGenerator``,
  unet_d3 and unet_d4 under batch, instance and no norm, in training and
  eval mode, zero and wrapped W (``UNET_CASES``: each depth with each norm,
  each of those with both W modes), the JAX weights converted from the
  port's: 2e-6 (the first run's largest difference was 1.3e-7); the
  dropout layers of unet_256 (3, flax's Dropout(0.5) semantics, masks
  from the generator the forward is given); the parameter names of the
  port's ``convert.py`` against the JAX U-Net's tree, and a round trip;
* ``gradient_penalty`` ('mixed') against the JAX function with the same
  alpha, through the pixel D with batch norm in training mode (the step's
  PatchGAN is held in the wgangp case of test_torch_port_pix2pix.py), and
  its 'real' and 'fake' types as 'mixed' at alpha 1 and 0: the
  penalty at rtol 1e-5
  and its gradient in D's parameters (the double backward) at rtol 1e-4
  and 1e-4 of the largest |value|; D's running averages left as they
  were. (The first run held the gradient at 1e-6 of the largest |value|
  and the pixel D failed at 2.4e-5: against an f64 evaluation of the same
  function the port's f32 gradient was within 4e-7 of the largest |value|
  and the jitted JAX one within 3.9e-5, so the bound is the JAX side's f32
  error with a margin.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu import losses as jax_losses
from biasgan_tpu.nn.discriminators import PixelDiscriminator as JaxPixel
from biasgan_tpu.nn.generators import UNetGenerator as JaxUNet
from biasgan_tpu.nn.layers import Norm
from biasgan_tpu_torch import losses
from biasgan_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from biasgan_tpu_torch.nn import define_D, define_G
from biasgan_tpu_torch.nn.generators import dropout
from biasgan_tpu_torch.nn.layers import BatchNorm, running_stats_frozen


def _tree(sd):
    """(params, batch_stats) of a port state_dict, as JAX arrays."""
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    return jax.tree_util.tree_map(jnp.asarray, state_dict_to_params(sd))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(dtype):
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    bn = BatchNorm(5, dtype=None if dtype == "float32" else tdt,
                   generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        bn.bias.normal_(generator=torch.Generator().manual_seed(2))
    params, stats = _tree({f"n.{k}": v for k, v in bn.state_dict().items()})
    norm = Norm("batch", dtype=None if dtype == "float32" else jnp.bfloat16)
    v = {"params": params["n"], "batch_stats": stats["n"]}
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    for call in range(3):
        x = (rng.normal(size=(3, 4, 6, 5)) * 2 + rng.normal(size=5)).astype(np.float32)
        dy = rng.normal(size=x.shape).astype(np.float32)

        def f(p, xx):
            y, mut = norm.apply({"params": p, "batch_stats": v["batch_stats"]}, xx, True,
                                mutable=["batch_stats"])
            return y.astype(jnp.float32), mut

        y, f_vjp, mut = jax.vjp(f, v["params"], jnp.asarray(x), has_aux=True)
        dp, dx = f_vjp(jnp.asarray(dy))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = bn.train()(xt)
        assert got.dtype == (torch.float32 if dtype == "float32" else tdt)
        got.float().backward(torch.from_numpy(dy))
        scale = 1 + np.abs(np.asarray(y))
        assert np.all(np.abs(_np(got) - np.asarray(y)) <= tol * scale), f"call {call} y"
        np.testing.assert_allclose(_np(xt.grad), np.asarray(dx), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(bn.weight.grad), np.asarray(dp["BatchNorm_0"]["scale"]),
                                   rtol=tol, atol=tol * 10)
        np.testing.assert_allclose(_np(bn.bias.grad), np.asarray(dp["BatchNorm_0"]["bias"]),
                                   rtol=tol, atol=tol * 10)
        bn.weight.grad = bn.bias.grad = None
        v["batch_stats"] = mut["batch_stats"]
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(_np(getattr(bn, ours)),
                                       np.asarray(v["batch_stats"]["BatchNorm_0"][theirs]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"call {call} {ours}")
    # eval: the running averages normalize, and nothing moves
    x = rng.normal(size=(2, 3, 3, 5)).astype(np.float32)
    before = bn.running_var.clone()
    with torch.no_grad():
        got = bn.eval()(torch.from_numpy(x))
    want = norm.apply(v, jnp.asarray(x), False).astype(jnp.float32)
    assert np.all(np.abs(_np(got) - np.asarray(want)) <= tol * (1 + np.abs(np.asarray(want))))
    assert torch.equal(bn.running_var, before)


class _ShardCtx:
    """One W shard's view of a two-shard spatial context, in one process:
    ``mean_w`` of this shard's tensors adds the other shard's local means
    (given) and halves, as the context's ``all_reduce`` of local means
    does. Its inputs must be x and x^2, in the order BatchNorm passes
    them."""

    n_shards = 2

    def __init__(self, other):
        self.other = other

    def mean_w(self, *xs, dims=(1, 2)):
        theirs = (self.other, self.other.square())
        return [(x.mean(dim=dims, keepdim=True) + o.mean(dim=dims, keepdim=True)) / 2
                for x, o in zip(xs, theirs)]


def test_batch_norm_frozen_stats_and_sharded_training():
    """``running_stats_frozen`` keeps the batch statistics but not the
    update; under a spatial context training takes W-global moments, so
    two W shards normalize as the whole field does and move the running
    averages as it does."""
    bn = BatchNorm(3).train()
    x = torch.randn(2, 4, 4, 3, generator=torch.Generator().manual_seed(0))
    with running_stats_frozen(bn):
        y = bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(3)) and int(bn.num_batches_tracked) == 0
    assert torch.equal(y, bn(x)) and int(bn.num_batches_tracked) == 1

    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 8, 3, generator=g) * 2 + 0.5
    whole = BatchNorm(3, generator=g).train()
    shards = [BatchNorm(3).train() for _ in range(2)]
    for s in shards:
        s.load_state_dict(whole.state_dict())
    halves = x.split(4, dim=2)
    want = whole(x)
    got = torch.cat([s(h, ctx=_ShardCtx(halves[1 - i]))
                     for i, (s, h) in enumerate(zip(shards, halves))], dim=2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # the shards' own moments would normalize otherwise
    local = BatchNorm(3).train()
    local.load_state_dict(whole.state_dict())
    assert float((local(halves[0]) - want[:, :, :4]).abs().max().detach()) > 1e-2
    for s in shards:
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(_np(getattr(s, name)), _np(getattr(whole, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    # eval: the running averages normalize, no context needed
    with torch.no_grad():
        assert torch.equal(shards[0].eval()(halves[0], ctx=object()),
                           shards[0](halves[0]))


# every depth with every norm, every norm and every depth with both W
# modes (each case in training and in eval mode)
UNET_CASES = [(3, "batch", "zero"), (3, "instance", "wrap"), (3, "none", "zero"),
              (4, "batch", "wrap"), (4, "instance", "zero"), (4, "none", "wrap")]


@pytest.mark.parametrize("downs,norm,w_mode", UNET_CASES)
def test_unet_matches_jax(downs, norm, w_mode):
    G = define_G(f"unet_d{downs}", 2, 3, ngf=8, norm=norm, w_mode=w_mode,
                 out_activation="none", generator=torch.Generator().manual_seed(downs))
    if norm == "batch":  # running averages away from their init
        for m in G.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.add_(0.1)
                m.running_var.mul_(1.5)
    params, stats = _tree(G.state_dict())
    v = {"params": params, **({"batch_stats": stats} if stats else {})}
    g = JaxUNet(output_nc=3, ngf=8, num_downs=downs, norm_type=norm, w_mode=w_mode,
                out_activation="none")
    x = np.random.default_rng(downs).normal(size=(2, 16, 32, 2)).astype(np.float32)
    for train in (False, True):
        if train and stats:
            want, mut = g.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
        else:
            want = g.apply(v, jnp.asarray(x), train)
        with torch.no_grad():
            got = G.train(train)(torch.from_numpy(x))
        assert got.shape == want.shape == (2, 16, 32, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6,
                                   err_msg=f"train={train}")
    if stats:  # the training forward moved the running averages as flax's
        got = _tree(G.state_dict())[1]
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(
                mut["batch_stats"])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_unet_256_dropout_layers():
    """unet_256 has num_downs - 5 = 3 dropout layers, which act in training
    only, with masks from the forward's generator (flax Dropout(0.5): kept
    values doubled): held on what up3 takes in, the skip concatenation after
    level 4's dropout."""
    G = define_G("unet_256", 1, 1, ngf=1, use_dropout=True,
                 generator=torch.Generator().manual_seed(0))
    assert sorted(G.drop_at) == [4, 5, 6]
    assert define_G("unet_256", 1, 1, ngf=1).drop_at == set()
    x = torch.randn(1, 256, 256, 1, generator=torch.Generator().manual_seed(1))
    seen = []
    G.ups[3].register_forward_pre_hook(lambda mod, args: seen.append(args[0][..., 8:]))

    def run(seed=None):
        with torch.no_grad():
            G(x, generator=None if seed is None else torch.Generator().manual_seed(seed))
        return seen.pop()

    G.train()
    a, b, c = run(3), run(3), run(4)
    dropped = (a == 0) & (c != 0)
    assert torch.equal(a == 0, b == 0) and dropped.any() and ((c == 0) & (a != 0)).any()
    with pytest.raises(ValueError, match="Generator"):
        G(x)
    G.eval()  # no dropout in eval: no generator needed, no value zeroed by it
    assert int((run() == 0).sum()) < int((a == 0).sum())
    h = torch.randn(4000)
    y = dropout(h, 0.5, torch.Generator().manual_seed(5))
    kept = y != 0
    assert torch.equal(y[kept], 2 * h[kept]) and 0.45 < kept.float().mean() < 0.55


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_unet_names_convert_both_ways(norm):
    """The port's U-Net state_dict names map onto the JAX U-Net's tree
    (``down{i}``, ``down_norm{i}``, ``up{i}``, ``up_norm{i}``; conv-
    transposes transposed, the batch norms' 1-D weights not), and back, bit
    for bit."""
    G = define_G("unet_d4", 2, 3, ngf=8, norm=norm, w_mode="wrap")
    sd = {k: v for k, v in G.state_dict().items() if not k.endswith("num_batches_tracked")}
    params, stats = state_dict_to_params(sd)
    g = JaxUNet(output_nc=3, ngf=8, num_downs=4, norm_type=norm, w_mode="wrap")
    shapes = jax.eval_shape(lambda: g.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 2))))
    for tree, col in ((params, "params"), (stats, "batch_stats")):
        want = jax.tree_util.tree_map(lambda s: s.shape, dict(shapes.get(col, {})))
        assert jax.tree_util.tree_map(np.shape, tree) == want, col
    back = params_to_state_dict(params, stats)
    assert sorted(back) == sorted(G.state_dict())
    for k, t in sd.items():
        assert torch.equal(back[k], t), k


def test_gradient_penalty_matches_jax():
    D = define_D("pixel", 2, ndf=8, norm="batch", generator=torch.Generator().manual_seed(0))
    params, stats = _tree(D.state_dict())
    d = JaxPixel(ndf=8, norm_type="batch")
    rng = np.random.default_rng(3)
    real = rng.normal(size=(3, 32, 32, 2)).astype(np.float32)
    fake = np.tanh(rng.normal(size=(3, 32, 32, 2))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    alpha = np.array(jax.random.uniform(key, (3, 1, 1, 1)))

    def jax_gp(p):
        def d_apply(x):
            return d.apply({"params": p, "batch_stats": stats}, x, True,
                           mutable=["batch_stats"])[0]
        return jax_losses.gradient_penalty(d_apply, jnp.asarray(real), jnp.asarray(fake), key)

    want, want_grads = jax.jit(jax.value_and_grad(jax_gp))(params)
    D.train()
    with running_stats_frozen(D):
        got = losses.gradient_penalty(D, torch.from_numpy(real), torch.from_numpy(fake),
                                      alpha=torch.from_numpy(alpha))
    got.backward()
    assert torch.equal(D.norms["1"].running_mean, torch.zeros(16)), "stats moved"
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    # a missing grad is a zero one (the conv-out bias leaves dD/dx alone)
    grads = {k: _np(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32)
             for k, p in D.named_parameters()}
    want_sd = {k: v.numpy() for k, v in params_to_state_dict(want_grads).items()}
    assert sorted(grads) == sorted(want_sd)
    atol = 1e-4 * max(float(np.abs(v).max()) for v in want_sd.values())
    for k, w in want_sd.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4, atol=atol, err_msg=k)


def test_gradient_penalty_types():
    """'real' and 'fake' take the penalty at real and at fake: 'mixed' with
    alpha 1 and 0; without an alpha, 'mixed' draws one per sample from the
    generator."""
    D = define_D("pixel", 2, ndf=4, norm="instance",
                 generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    real, fake = torch.randn(3, 8, 8, 2, generator=g), torch.randn(3, 8, 8, 2, generator=g)

    def gp(**kw):
        return losses.gradient_penalty(D, real, fake, **kw).detach()

    for lp_type, a in (("real", 1.0), ("fake", 0.0)):
        assert torch.equal(gp(lp_type=lp_type), gp(alpha=torch.full((3, 1, 1, 1), a)))
    alpha = torch.rand((3, 1, 1, 1), generator=torch.Generator().manual_seed(2))
    assert torch.equal(gp(generator=torch.Generator().manual_seed(2)), gp(alpha=alpha))
    with pytest.raises(ValueError, match="gradient-penalty type"):
        gp(lp_type="bogus")
