"""CycleGAN: unpaired sim <-> obs bias correction, the training step.

Counterpart of ``biasgan_tpu/models/cyclegan.py`` (:130-396), the
reference's ``CycleGANModel``:

  forward: fake_B = G_A(A); rec_A = G_B(fake_B); fake_A = G_B(B);
           rec_B = G_A(fake_A); idt_A = G_A(B); idt_B = G_B(A)
  G step (first; the Ds are held constant):
      GAN(D_A(fake_B)) + GAN(D_B(fake_A))
    + lambda_A L1(rec_A, A) + lambda_B L1(rec_B, B)
    + lambda_idt (lambda_B L1(idt_A, B) + lambda_A L1(idt_B, A)),
    one Adam over G_A + G_B;
  D step: each D sees the real batch and a pool-replayed fake, 0.5
    weighted; one Adam over D_A + D_B.

With a per-sample norm and no dropout the six G passes run as three
batched dispatches ordered by their data dependency (G_A([A; B]),
G_B([B; fake_B; A]), G_A(fake_A)), and each D pair as one 2B pass, exactly
as the JAX step does; otherwise they run one by one. The kernel routes
(--fused_blocks, --pallas_conv, --conv7_pallas, --force_pallas_norm) are
attributes of the nets (``build_nets``).

Under spatial sharding (``ctx``, a ``parallel.spatial.HaloCtx``; JAX
:132-380 with ``spatial_train_step``) each rank prepares the global batch
with the same draws and takes its W shard; the Gs run on the shards under
the context, the PatchGAN Ds on the whole W gathered on every rank (their
W-shrinking final convs cannot shard), the losses and both optimizers'
grads are averaged over the ranks before Adam, and the replay pools hold
this rank's W slice of every pooled fake, with the same decisions on every
rank. So every rank takes the one-device step, and every rank's parameters
stay equal to every other's.

On the 2-D mesh (both contexts: ``ctx`` the rank's row, ``data`` its
column) each row steps on its data slice sharded on W: the pools gather
the fakes over the data group and stay sharded on W, and the grads, the
running averages and the losses are averaged over every rank of the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from biasgan_tpu_torch import losses
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
from biasgan_tpu_torch.utils.image_pool import create_pool, pool_query

LOSS_NAMES = ("D_A", "G_A", "cycle_A", "idt_A", "D_B", "G_B", "cycle_B", "idt_B")


@dataclass
class CycleGANConfig:
    lambda_A: float = 10.0
    lambda_B: float = 10.0
    lambda_identity: float = 0.5


def build_nets(cfg, generator: Optional[torch.Generator] = None) -> Dict[str, torch.nn.Module]:
    """G_A (A -> B), G_B (B -> A), D_A (judges B), D_B (judges A), with
    the configuration's kernel routes. Weights are drawn from
    ``generator`` in the order G_A, G_B, D_A, D_B."""
    dtype = compute_dtype_of(cfg.compute_dtype)

    def g(cin, cout):
        return generator_of(cfg, cin, cout, generator=generator)

    def d(cin):
        return define_D(
            cfg.netD, cin, ndf=cfg.ndf, n_layers_D=cfg.n_layers_D, norm=cfg.norm,
            init_type=cfg.init_type, init_gain=cfg.init_gain,
            w_mode=cfg.w_pad_mode or "zero", compute_dtype=dtype,
            fused_norm=cfg.force_pallas_norm, generator=generator,
        )

    return {
        "G_A": g(cfg.input_nc, cfg.output_nc),
        "G_B": g(cfg.output_nc, cfg.input_nc),
        "D_A": d(cfg.output_nc),
        "D_B": d(cfg.input_nc),
    }


def create_state(cfg, device, nets: Optional[Dict[str, torch.nn.Module]] = None,
                 ctx=None) -> GANTrainState:
    """The training state on ``device``: the four nets (seeded from
    --seed unless given), one Adam over both Gs and one over both Ds, and
    the two replay pools when --pool_size > 0 (under a spatial context
    ``ctx``, of this rank's W shard)."""
    if nets is None:
        nets = build_nets(cfg, torch.Generator().manual_seed(cfg.seed))
    nets = {k: v.to(device).train() for k, v in nets.items()}
    pools = {}
    if cfg.pool_size > 0:
        h = w = cfg.crop_size
        if ctx is not None:
            w //= ctx.n_shards
        pools = {
            "fake_B": create_pool(cfg.pool_size, (h, w, cfg.output_nc), device),
            "fake_A": create_pool(cfg.pool_size, (h, w, cfg.input_nc), device),
        }
    return GANTrainState(
        step=0,
        lr_scale=1.0,
        nets=nets,
        opts={
            "G": adam_of(cfg, named_params(nets, ("G_A", "G_B"))),
            "D": adam_of(cfg, named_params(nets, ("D_A", "D_B"))),
        },
        pools=pools,
    )


def _grads(opt) -> Dict[str, torch.Tensor]:
    return {
        n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
        for n, p in opt.params
    }


def make_train_step(cfg, fuse_g: Optional[bool] = None, debug_grads: bool = False,
                    ctx=None, data=None):
    """The CycleGAN step: ``step(state, batch, generator) -> (losses,
    visuals)``, updating ``state`` in place. ``batch`` holds device tensors
    (A, B and, for climate data, their stats); ``generator`` draws the
    step's augmentation and pool decisions. ``debug_grads`` adds the step's
    G and D gradients to the visuals (the JAX step's hook of the same name,
    for equivalence tests).

    ``ctx``: the step of one rank of a spatially sharded run (module
    docstring). ``batch`` is then the global batch, the same on every
    rank, and the visuals are this rank's W shards; the losses and the
    grads are the means over the ranks.

    ``data``: the step of one rank of a data-parallel run (module
    docstring); ``batch`` is then the rank's slice, and the losses and the
    grads the means over the ranks. ``generator`` defaults to
    ``step_generator(--seed, step)``."""
    lr_fn = make_lr_schedule(cfg)
    gan_mode = cfg.gan_mode
    lam_A, lam_B, lam_idt = cfg.lambda_A, cfg.lambda_B, cfg.lambda_identity
    fuse_d = cfg.norm != "batch"
    if fuse_g is None:
        fuse_g = cfg.norm != "batch" and not cfg.dropout()

    def for_d(t):
        """What a D sees of a G's output: the whole W (gathered on every
        rank, differentiably) under a context."""
        return t if ctx is None else ctx.all_gather_w(t)

    # what spans every rank: the data context spans the mesh where both are
    mesh = data or ctx

    def mean_grads(opt):
        if mesh is not None:
            mesh.mean_grads_([p for _, p in opt.params])

    def query(pool, fake, generator):
        """The pool's answer to this rank's fakes: under data parallelism
        the global batch's fakes query the one pool, and this rank takes
        its slice back."""
        if data is None:
            return pool_query(pool, fake, generator)
        pool, out = pool_query(pool, data.all_gather_batch(fake), generator)
        return pool, data.rank_slice(out)

    def step(state: GANTrainState, batch, generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = step_generator(cfg.seed, state.step)
        # the rank's own draws (augmentation, dropout); the pools draw from
        # the shared generator
        own = generator if data is None else rank_generator(generator, data.rank)
        batch = prepare_batch(batch, own, cfg, train=True)
        # the Ds' real inputs: the whole W, which every rank holds
        whole_A, whole_B = resolve_direction(batch, cfg.direction)
        if ctx is not None:
            batch = shard_batch(batch, ctx)
        real_A, real_B = resolve_direction(batch, cfg.direction)
        # the resnet blocks' dropout masks, where dropout is on
        drop = device_generator(own, real_A.device) if cfg.dropout() else None
        G_A, G_B = (lambda x, G=state.nets[k]: G(x, ctx=ctx, generator=drop)
                    for k in ("G_A", "G_B"))
        D_A, D_B = state.nets["D_A"], state.nets["D_B"]
        lr = lr_fn(state.step, state.lr_scale)
        b = real_A.shape[0]

        # ---- G update (first; the Ds constant) ----
        for p in (*D_A.parameters(), *D_B.parameters()):
            p.requires_grad_(False)
        if fuse_g:
            out1 = G_A(torch.cat([real_A, real_B]) if lam_idt > 0 else real_A)
            fake_B = out1[:b]
            idt_A = out1[b:] if lam_idt > 0 else None
            out2 = G_B(torch.cat([real_B, fake_B] + ([real_A] if lam_idt > 0 else [])))
            fake_A, rec_A = out2[:b], out2[b : 2 * b]
            idt_B = out2[2 * b :] if lam_idt > 0 else None
            rec_B = G_A(fake_A)
        else:
            fake_B = G_A(real_A)
            rec_A = G_B(fake_B)
            fake_A = G_B(real_B)
            rec_B = G_A(fake_A)
            idt_A = G_A(real_B) if lam_idt > 0 else None
            idt_B = G_B(real_A) if lam_idt > 0 else None
        zero = torch.zeros((), device=real_A.device)
        if lam_idt > 0:
            loss_idt_A = losses.l1_loss(idt_A, real_B) * lam_B * lam_idt
            loss_idt_B = losses.l1_loss(idt_B, real_A) * lam_A * lam_idt
        else:
            loss_idt_A = loss_idt_B = zero
        loss_G_A = losses.gan_loss(D_A(for_d(fake_B)), True, gan_mode)
        loss_G_B = losses.gan_loss(D_B(for_d(fake_A)), True, gan_mode)
        loss_cycle_A = losses.l1_loss(rec_A, real_A) * lam_A
        loss_cycle_B = losses.l1_loss(rec_B, real_B) * lam_B
        loss_g = loss_G_A + loss_G_B + loss_cycle_A + loss_cycle_B + loss_idt_A + loss_idt_B
        for _, p in state.opts["G"].params:
            p.grad = None
        loss_g.backward()
        mean_grads(state.opts["G"])
        for p in (*D_A.parameters(), *D_B.parameters()):
            p.requires_grad_(True)
        g_grads = _grads(state.opts["G"]) if debug_grads else None
        state.opts["G"].step(lr)
        fake_B, fake_A = fake_B.detach(), fake_A.detach()

        # ---- replay pools (reference ImagePool.query) ----
        fake_B_q, fake_A_q = fake_B, fake_A
        if state.pools:
            state.pools["fake_B"], fake_B_q = query(state.pools["fake_B"], fake_B, generator)
            state.pools["fake_A"], fake_A_q = query(state.pools["fake_A"], fake_A, generator)

        # ---- D update (reference backward_D_basic, 0.5 weighting) ----
        def d_pair(D, real, fake):
            if fuse_d:
                pr, pf = torch.chunk(D(torch.cat([real, fake])), 2)
            else:
                pr, pf = D(real), D(fake)
            return 0.5 * (losses.gan_loss(pr, True, gan_mode) + losses.gan_loss(pf, False, gan_mode))

        loss_D_A = d_pair(D_A, whole_B, for_d(fake_B_q))
        loss_D_B = d_pair(D_B, whole_A, for_d(fake_A_q))
        for _, p in state.opts["D"].params:
            p.grad = None
        (loss_D_A + loss_D_B).backward()
        mean_grads(state.opts["D"])
        d_grads = _grads(state.opts["D"]) if debug_grads else None
        state.opts["D"].step(lr)
        for _, p in state.opts["G"].params + state.opts["D"].params:
            p.grad = None
        if mesh is not None:
            for net in state.nets.values():
                mesh.mean_buffers_(net)
        state.step += 1

        vals = (loss_D_A, loss_G_A, loss_cycle_A, loss_idt_A,
                loss_D_B, loss_G_B, loss_cycle_B, loss_idt_B)
        vals = torch.stack([v.detach().float() for v in vals])
        if mesh is not None:
            vals = mesh.mean(vals)
        loss_dict = dict(zip(LOSS_NAMES, vals))
        visuals = {
            "real_A": real_A, "fake_B": fake_B, "rec_A": rec_A.detach(),
            "real_B": real_B, "fake_A": fake_A, "rec_B": rec_B.detach(),
        }
        if debug_grads:
            visuals["_g_grads"], visuals["_d_grads"] = g_grads, d_grads
        return loss_dict, visuals

    return step


def make_eval_fn(cfg):
    """The four G forwards of the reference's test() (JAX :399-424):
    ``eval_fn(state, batch, generator=None, train=False, ctx=None) ->
    visuals`` with fake_B = G_A(A), rec_A = G_B(fake_B), fake_A = G_B(B),
    rec_B = G_A(fake_A). ``train=False`` normalizes with the running
    averages and drops no unit; ``train=True`` is the reference's test
    without --eval (batch statistics, dropout masks from ``generator``,
    default ``step_generator(--seed, step)``; the running averages stay as
    they are: JAX drops the update, :406-412).
    Under a spatial context ``ctx`` the batch is the global one and the
    visuals are this rank's W shards."""

    @torch.no_grad()
    def eval_fn(state: GANTrainState, batch, generator: Optional[torch.Generator] = None,
                train: bool = False, ctx=None):
        batch = prepare_batch(batch, None, cfg, train=False)
        if ctx is not None:
            batch = shard_batch(batch, ctx)
        real_A, real_B = resolve_direction(batch, cfg.direction)
        gens = [state.nets["G_A"], state.nets["G_B"]]
        with eval_forward(gens, state, cfg, train, generator, real_A.device) as drop:
            G_A, G_B = (lambda x, G=g: G(x, ctx=ctx, generator=drop) for g in gens)
            fake_B = G_A(real_A)
            rec_A = G_B(fake_B)
            fake_A = G_B(real_B)
            rec_B = G_A(fake_A)
        return {"real_A": real_A, "fake_B": fake_B, "rec_A": rec_A,
                "real_B": real_B, "fake_A": fake_A, "rec_B": rec_B}

    return eval_fn
