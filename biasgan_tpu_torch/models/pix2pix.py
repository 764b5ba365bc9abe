"""pix2pix: paired image-to-image / bias-correction GAN, the training step.

Counterpart of ``biasgan_tpu/models/pix2pix.py``, the reference's
``Pix2PixModel``:

  forward: fake_B = G(real_A), once, in training mode
  D step (first): 0.5 (GAN(D(cat(A, fake_B.detach())), fake)
                       + GAN(D(cat(A, B)), real)) [+ lambda_gp GP], Adam
  G step: GAN(D_new(cat(A, fake_B)), real) + lambda_L1 L1(fake_B, B), the
          gradient through the same G forward, Adam with the same LR

Batch-norm running statistics move as the JAX step moves them: G's once
(its one forward); D's on the fake pass, then the real pass, then the G
head's pass with the updated D; the gradient penalty's D forward
normalizes with batch statistics and leaves D's running averages as they
were (the JAX step throws its stats away, :220-225). Without batch norm the
fake and real D passes run as one 2B pass (``[fake; real]``), exact for a
per-sample norm (:200-218). Dropout masks and the penalty's alpha come
from the step's CPU generator (``step_generator``): the masks from a device
generator it seeds.

The kernel routes (--fused_blocks, --pallas_conv, --conv7_pallas,
--force_pallas_norm) are attributes of the nets (``build_nets``), as in
``models/cyclegan.py``: a resnet G takes them; the U-Net has no layer they
take (the JAX U-Net reaches no Pallas kernel), and the CLIs say so.

Under data parallelism (``data``, a ``parallel.DataCtx``; JAX :151-153,
:232, :257, :264-266, :280) each rank steps on its slice of the global
batch with its own draws (``rank_generator``): D's grads are averaged over
the ranks before D's Adam, G's before G's, the losses after, and the
batch-norm running averages of G and D after the update; the forward's
batch statistics stay the rank's, as in the JAX step. The visuals are the
rank's.

Under spatial sharding (``ctx``, a ``parallel.spatial.HaloCtx``; JAX
:107-289 under ``spatial_train_step``) every rank of the spatial row
prepares the row's global batch with the same draws (flip and roll are not
local to a shard) and takes its W shard; G runs once on the shard under
the context (halos, W-global batch moments, each rank's columns of the
whole-W dropout masks), the D on the whole W gathered on every rank (a
PatchGAN's W-shrinking final convs cannot shard; the pixel D, which JAX
keeps sharded, computes the same function gathered), its fake input
gathered differentiably, so the G head's cotangent returns to each shard; the penalty runs on the gathered fields with one alpha per
row. D's grads are averaged before D's Adam, G's before G's, then the
losses and the running averages. So every rank takes the one-device step
of its row's batch, and the visuals are this rank's W shards. wgangp with
the pixel D raises, as in JAX (:129-134). With ``data`` too (the 2-D
mesh), the data context is the rank's column: the draws are the data
index's, and the means span every rank of the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from biasgan_tpu_torch import losses
from biasgan_tpu_torch.config import TrainConfig
from biasgan_tpu_torch.models.common import (
    GANTrainState,
    adam_of,
    device_generator,
    eval_forward,
    generator_of,
    make_lr_schedule,
    named_params,
    prepare_batch,
    rank_generator,
    resolve_direction,
    shard_batch,
    step_generator,
)
from biasgan_tpu_torch.nn import compute_dtype_of, define_D
from biasgan_tpu_torch.nn.layers import running_stats_frozen

LOSS_NAMES = ("G_GAN", "G_L1", "D_real", "D_fake")


def check_sharded(cfg) -> None:
    """Raises for the one configuration the sharded step refuses, as the
    JAX step does (:129-134): wgangp with the pixel D."""
    if cfg.gan_mode == "wgangp" and cfg.netD == "pixel":
        raise NotImplementedError(
            "--spatial_mesh with --gan_mode wgangp and --netD pixel: the gradient "
            "penalty's norms are W-global, and the JAX package keeps the pixel D sharded, "
            "so it refuses the pair; use a PatchGAN --netD")


@dataclass
class Pix2PixConfig:
    lambda_L1: float = 100.0
    lambda_gp: float = 10.0  # only used when gan_mode == 'wgangp'


def build_nets(cfg, generator: Optional[torch.Generator] = None,
               train: bool = True) -> Dict[str, torch.nn.Module]:
    """G (A -> B) and, with ``train``, the conditional D (judges cat(A, B)),
    with the configuration's kernel routes. Weights are drawn from
    ``generator`` in the order G, D."""
    nets = {"G": generator_of(cfg, cfg.input_nc, cfg.output_nc, generator=generator)}
    if train:
        nets["D"] = define_D(
            cfg.netD, cfg.input_nc + cfg.output_nc, ndf=cfg.ndf, n_layers_D=cfg.n_layers_D,
            norm=cfg.norm, init_type=cfg.init_type, init_gain=cfg.init_gain,
            w_mode=cfg.w_pad_mode or "zero", compute_dtype=compute_dtype_of(cfg.compute_dtype),
            fused_norm=cfg.force_pallas_norm, generator=generator,
        )
    return nets


def create_state(cfg, device, nets: Optional[Dict[str, torch.nn.Module]] = None,
                 ctx=None) -> GANTrainState:
    """The state on ``device``, the nets seeded from --seed unless given: a
    training config's G, D and an Adam for each; a test config's G alone
    (the reference builds D and the optimizers only under isTrain,
    :83-103). The state is the same under a spatial context ``ctx``."""
    train = isinstance(cfg, TrainConfig)
    if nets is None:
        nets = build_nets(cfg, torch.Generator().manual_seed(cfg.seed), train)
    nets = {k: v.to(device).train() for k, v in nets.items()}
    opts = {k: adam_of(cfg, named_params(nets, (k,))) for k in nets} if train else {}
    return GANTrainState(step=0, lr_scale=1.0, nets=nets, opts=opts)


def _zero_grads(opt) -> None:
    for _, p in opt.params:
        p.grad = None


def _grad_norm(opt) -> torch.Tensor:
    """The global L2 norm of the optimizer's gradients, in f32 (a missing
    grad is zero)."""
    sq = [p.grad.float().square().sum() for _, p in opt.params if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


def make_train_step(cfg, debug_grad_norms: bool = False, ctx=None, data=None):
    """The pix2pix step: ``step(state, batch, generator=None, gp_alpha=None)
    -> (losses, visuals)``, updating ``state`` in place (module docstring).
    ``batch`` holds device tensors (A, B and, for climate data, their
    stats); ``generator`` (CPU; default ``step_generator(--seed, step)``)
    draws the augmentation, the dropout masks' seed and the penalty's alpha;
    ``gp_alpha`` ((N, 1, 1, 1)) gives that alpha instead. The losses are
    G_GAN, G_L1, D_real, D_fake, and with ``debug_grad_norms`` the global
    norms of the grads Adam takes, g_grad_norm and d_grad_norm (the JAX
    step's hook).

    ``data``: the step of one rank of a data-parallel run (module
    docstring); ``batch`` and ``gp_alpha`` are then the rank's slice, the
    draws the rank's own, and the losses and grad norms the means over the
    ranks.

    ``ctx``: the step of one rank of a spatially sharded run (module
    docstring); ``batch`` is then the row's global batch, the same on
    every rank of the row, ``gp_alpha`` the row's, and the losses and grad
    norms the means over the ranks."""
    if ctx is not None:
        check_sharded(cfg)
    lr_fn = make_lr_schedule(cfg)
    gan_mode = cfg.gan_mode
    lambda_l1, lambda_gp = cfg.lambda_L1, cfg.lambda_gp
    fuse_d = cfg.norm != "batch"
    # what spans every rank: the data context spans the mesh where both are
    mesh = data or ctx

    def for_d(t):
        """What D sees of a W-sharded field: the whole W (gathered on every
        rank, differentiably) under a context."""
        return t if ctx is None else ctx.all_gather_w(t)

    def step(state: GANTrainState, batch, generator: Optional[torch.Generator] = None,
             gp_alpha: Optional[torch.Tensor] = None):
        if generator is None:
            generator = step_generator(cfg.seed, state.step)
        if data is not None:
            generator = rank_generator(generator, data.rank)
        batch = prepare_batch(batch, generator, cfg, train=True)
        # D's real inputs: the whole W, which every rank of the row holds
        whole_A, whole_B = resolve_direction(batch, cfg.direction)
        if ctx is not None:
            batch = shard_batch(batch, ctx)
        real_A, real_B = resolve_direction(batch, cfg.direction)
        G, D = state.nets["G"], state.nets["D"]
        drop = device_generator(generator, real_A.device) if cfg.dropout() else None
        lr = lr_fn(state.step, state.lr_scale)

        # one G forward serves both updates (the reference's forward())
        fake_B = G(real_A, ctx=ctx, generator=drop)
        real_AB = torch.cat([whole_A, whole_B], dim=-1)
        fake_AB = torch.cat([whole_A, for_d(fake_B.detach())], dim=-1)

        # ---- D update (first, as in the reference) ----
        if fuse_d:
            pred_fake, pred_real = torch.chunk(D(torch.cat([fake_AB, real_AB])), 2)
        else:
            pred_fake = D(fake_AB)
            pred_real = D(real_AB)
        loss_D_fake = losses.gan_loss(pred_fake, False, gan_mode)
        loss_D_real = losses.gan_loss(pred_real, True, gan_mode)
        loss_D = 0.5 * (loss_D_fake + loss_D_real)
        if gan_mode == "wgangp":
            with running_stats_frozen(D):
                loss_D = loss_D + lambda_gp * losses.gradient_penalty(
                    D, real_AB, fake_AB, alpha=gp_alpha, generator=generator)
        _zero_grads(state.opts["D"])
        loss_D.backward()
        if mesh is not None:
            mesh.mean_grads_([p for _, p in state.opts["D"].params])
        d_norm = _grad_norm(state.opts["D"]) if debug_grad_norms else None
        state.opts["D"].step(lr)

        # ---- G update, through the updated D (its grads not kept) ----
        for p in D.parameters():
            p.requires_grad_(False)
        try:
            loss_G_GAN = losses.gan_loss(D(torch.cat([whole_A, for_d(fake_B)], dim=-1)), True,
                                         gan_mode)
            loss_G_L1 = losses.l1_loss(fake_B, real_B) * lambda_l1
            _zero_grads(state.opts["G"])
            (loss_G_GAN + loss_G_L1).backward()
        finally:
            for p in D.parameters():
                p.requires_grad_(True)
        if mesh is not None:
            mesh.mean_grads_([p for _, p in state.opts["G"].params])
        g_norm = _grad_norm(state.opts["G"]) if debug_grad_norms else None
        state.opts["G"].step(lr)
        for opt in state.opts.values():
            _zero_grads(opt)
        if mesh is not None:
            for net in (G, D):
                mesh.mean_buffers_(net)
        state.step += 1

        vals = [loss_G_GAN, loss_G_L1, loss_D_real, loss_D_fake]
        names = list(LOSS_NAMES)
        if debug_grad_norms:
            vals += [g_norm, d_norm]
            names += ["g_grad_norm", "d_grad_norm"]
        vals = torch.stack([v.detach().float() for v in vals])
        if mesh is not None:
            vals = mesh.mean(vals)
        loss_dict = dict(zip(names, vals))
        return loss_dict, {"real_A": real_A, "fake_B": fake_B.detach(), "real_B": real_B}

    return step


def make_eval_fn(cfg):
    """G's forward (the reference's model.test()): ``eval_fn(state, batch,
    generator=None, train=False, ctx=None) -> visuals``. ``train=True`` is
    the reference's test without --eval: batch statistics and dropout
    (masks from ``generator``, default ``step_generator(--seed, step)``),
    and G's running averages stay as they are (JAX applies G with
    ``mutable=["batch_stats"]`` and drops the update, :300-309); otherwise
    the running averages normalize. Under a spatial context ``ctx`` the
    batch is the global one and the visuals are this rank's W shards (JAX
    models/base.py:220-245 runs the eval forward on the sharded batch)."""

    @torch.no_grad()
    def eval_fn(state: GANTrainState, batch, generator: Optional[torch.Generator] = None,
                train: bool = False, ctx=None):
        batch = prepare_batch(batch, None, cfg, train=False)
        if ctx is not None:
            batch = shard_batch(batch, ctx)
        real_A, real_B = resolve_direction(batch, cfg.direction)
        G = state.nets["G"]
        with eval_forward([G], state, cfg, train, generator, real_A.device) as drop:
            fake_B = G(real_A, ctx=ctx, generator=drop)
        return {"real_A": real_A, "fake_B": fake_B, "real_B": real_B}

    return eval_fn
