"""The 'template' model: a generator trained with L1 regression alone, no
discriminator. Counterpart of ``biasgan_tpu/models/template.py``
(:48-158), the reference family's documented example of adding a model;
a deterministic baseline for the bias-correction GANs.

  step: fake_B = G(real_A) in training mode; loss G_L1 = lambda_regression
        L1(fake_B, real_B); one Adam over G; G's batch-norm running
        averages move once, as in the pix2pix step

Under data parallelism (``data``, a ``parallel.DataCtx``) each rank steps
on its slice with its own draws, the grads are averaged before Adam and
the loss and the running averages after, as the pix2pix step does.
Spatial sharding is refused, as in JAX (:151-154).

To add a model to the port: write its config dataclass (its fields become
CLI flags), ``create_state``, ``make_train_step`` and ``make_eval_fn`` as
functions over a ``GANTrainState``, and register an entry in
``models/__init__.py``.

  python -m biasgan_tpu_torch.train --model template --dataset_mode synthetic \\
      --netG unet_d4 --crop_size 64 --input_nc 1 --output_nc 1 --device cpu
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from biasgan_tpu_torch import losses
from biasgan_tpu_torch.config import TrainConfig
from biasgan_tpu_torch.models import pix2pix
from biasgan_tpu_torch.models.common import (
    GANTrainState,
    adam_of,
    device_generator,
    generator_of,
    make_lr_schedule,
    named_params,
    prepare_batch,
    rank_generator,
    resolve_direction,
    step_generator,
)

LOSS_NAMES = ("G_L1",)


@dataclass
class TemplateConfig:
    lambda_regression: float = 1.0  # weight of the L1 regression loss


def check_sharded(cfg) -> None:
    raise NotImplementedError(
        "--spatial_mesh: the template model does not train spatially sharded (as in the "
        "JAX package); see pix2pix")


def create_state(cfg, device, nets: Optional[Dict[str, torch.nn.Module]] = None,
                 ctx=None) -> GANTrainState:
    """G on ``device`` (seeded from --seed unless given), and for a training
    config its Adam."""
    if nets is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        nets = {"G": generator_of(cfg, cfg.input_nc, cfg.output_nc, generator=gen)}
    nets = {k: v.to(device).train() for k, v in nets.items()}
    train = isinstance(cfg, TrainConfig)
    opts = {"G": adam_of(cfg, named_params(nets, ("G",)))} if train else {}
    return GANTrainState(step=0, lr_scale=1.0, nets=nets, opts=opts)


def make_train_step(cfg, ctx=None, data=None):
    """The template step: ``step(state, batch, generator=None) -> (losses,
    visuals)``, updating ``state`` in place (module docstring). The CPU
    ``generator`` (default ``step_generator(--seed, step)``) draws the
    augmentation and the dropout masks' seed."""
    if ctx is not None:
        check_sharded(cfg)
    lr_fn = make_lr_schedule(cfg)
    lam = cfg.lambda_regression

    def step(state: GANTrainState, batch, generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = step_generator(cfg.seed, state.step)
        if data is not None:
            generator = rank_generator(generator, data.rank)
        batch = prepare_batch(batch, generator, cfg, train=True)
        real_A, real_B = resolve_direction(batch, cfg.direction)
        G, opt = state.nets["G"], state.opts["G"]
        drop = device_generator(generator, real_A.device) if cfg.dropout() else None
        lr = lr_fn(state.step, state.lr_scale)
        fake_B = G(real_A, generator=drop)
        loss = lam * losses.l1_loss(fake_B, real_B)
        for _, p in opt.params:
            p.grad = None
        loss.backward()
        if data is not None:
            data.mean_grads_([p for _, p in opt.params])
        opt.step(lr)
        for _, p in opt.params:
            p.grad = None
        if data is not None:
            data.mean_buffers_(G)
        state.step += 1
        loss = loss.detach().float()
        if data is not None:
            loss = data.mean(loss)
        return {"G_L1": loss}, {"real_A": real_A, "fake_B": fake_B.detach(), "real_B": real_B}

    return step


# the eval forward is pix2pix's: G on the prepared batch's source side
make_eval_fn = pix2pix.make_eval_fn
