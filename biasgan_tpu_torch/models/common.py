"""What the train steps share: the train state, Adam with optax's
semantics, the LR policies, and the in-step batch preparation.

Counterpart of ``biasgan_tpu/models/common.py``. The JAX package keeps the
whole state in one pytree and differentiates a pure step; the port keeps
``nn.Module``s and optimizer tensors in a plain ``GANTrainState`` and
updates them in place, one step at a time.

Adam is ``optax.scale_by_adam`` (b2 0.999, eps 1e-8, outside the square
root, bias-corrected moments) with the learning rate applied by hand,
``p - lr * m_hat / (sqrt(v_hat) + eps)``, one state per optimizer
(CycleGAN shares one over G_A + G_B). The LR policies are evaluated from
the step counter in f32, as the JAX step does in-graph; 'plateau' rides a
host-updated ``lr_scale``.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from biasgan_tpu_torch.config import route_on
from biasgan_tpu_torch.data.transforms import in_step_augment, standardize
from biasgan_tpu_torch.nn import compute_dtype_of, define_G
from biasgan_tpu_torch.nn.layers import running_stats_frozen
from biasgan_tpu_torch.parallel.spatial import shard_w


class Adam:
    """optax ``scale_by_adam(b1, b2, eps)`` over named parameters, with the
    update ``p -= lr * direction``. The moments are f32 tensors beside the
    parameters; ``count`` is the number of updates taken."""

    def __init__(
        self,
        params: Iterable[Tuple[str, nn.Parameter]],
        beta1: float = 0.5,
        beta2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.params: List[Tuple[str, nn.Parameter]] = list(params)
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params}

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """One update from each parameter's ``.grad`` (a missing grad is a
        zero grad, as in a JAX grad tree)."""
        self.count += 1
        c1 = 1.0 - self.b1**self.count
        c2 = 1.0 - self.b2**self.count
        for name, p in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = g.float()
            mu, nu = self.mu[name], self.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            direction = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.sub_(lr * direction.to(p.dtype))

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, sd: Dict) -> None:
        self.count = int(sd["count"])
        for name, _ in self.params:
            self.mu[name].copy_(sd["mu"][name])
            self.nu[name].copy_(sd["nu"][name])


def adam_of(cfg, params) -> Adam:
    """Adam from a TrainConfig (beta1; --adam_mu_dtype float32 only)."""
    mu_dtype = getattr(cfg, "adam_mu_dtype", "float32")
    if mu_dtype == "bfloat16":
        raise NotImplementedError(
            "--adam_mu_dtype bfloat16 (a bf16 first moment) is not ported yet"
        )
    if mu_dtype != "float32":
        raise ValueError(f"--adam_mu_dtype {mu_dtype!r}: must be float32 or bfloat16")
    return Adam(params, beta1=cfg.beta1)


def generator_of(cfg, input_nc: int, output_nc: int, out_activation: Optional[str] = None,
                 fused_updown: bool = False,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """A generator of the configuration (--netG, --ngf, --norm, dropout,
    init, --w_pad_mode, --compute_dtype) from ``input_nc`` to
    ``output_nc`` channels, on the configuration's kernel routes
    (--fused_blocks, --conv7_pallas, --force_pallas_norm, --pallas_conv,
    and with ``fused_updown`` --fused_updown, an inference-only route),
    ending in ``out_activation`` (default --netG_activation). Weights are
    drawn from ``generator``."""
    return define_G(
        cfg.netG, input_nc, output_nc, ngf=cfg.ngf, norm=cfg.norm, use_dropout=cfg.dropout(),
        init_type=cfg.init_type, init_gain=cfg.init_gain, w_mode=cfg.w_pad_mode or None,
        compute_dtype=compute_dtype_of(cfg.compute_dtype),
        out_activation=out_activation or cfg.netG_activation,
        fused_blocks=cfg.fused_blocks, fused_updown=fused_updown and cfg.fused_updown,
        conv7=route_on("--conv7_pallas", cfg.conv7_pallas), fused_norm=cfg.force_pallas_norm,
        pallas_conv=route_on("--pallas_conv", cfg.pallas_conv), generator=generator,
    )


def eval_generator(seed: int, calls: int) -> torch.Generator:
    """The CPU generator of the ``calls``-th test forward's draws (its
    dropout masks' seed), from (--seed, the forward's count) and off the
    training steps' stream (``step_generator``), as the JAX package folds
    its own counter into a separate key (models/base.py:170-174)."""
    seed = np.random.SeedSequence([int(seed), 0x7E57, int(calls)]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(seed[0]) >> 1)


@contextlib.contextmanager
def eval_forward(gens, state, cfg, train: bool, generator: Optional[torch.Generator], device):
    """The block runs the generators ``gens`` as the reference's test()
    does: with ``train`` in training mode (batch statistics, dropout) but
    with their running averages left as they are (the JAX eval functions
    apply G with ``mutable=["batch_stats"]`` and drop the update), else in
    eval mode; their modes are restored after. Yields the device generator
    of the dropout masks (seeded from ``generator``, default
    ``step_generator(--seed, step)``), or None without dropout."""
    modes = [g.training for g in gens]
    drop = None
    if train and cfg.dropout():
        gen = generator if generator is not None else step_generator(cfg.seed, state.step)
        drop = device_generator(gen, device)
    try:
        with contextlib.ExitStack() as frozen:
            for g in gens:
                g.train(train)
                frozen.enter_context(running_stats_frozen(g))
            yield drop
    finally:
        for g, m in zip(gens, modes):
            g.train(m)


def named_params(nets: Dict[str, nn.Module], names: Iterable[str]):
    """(net.param, tensor) over the nets ``names``, in order."""
    return [(f"{n}.{k}", p) for n in names for k, p in nets[n].named_parameters()]


def make_lr_schedule(cfg):
    """The reference's ``get_scheduler`` policies from the step counter:
    epoch = step // steps_per_epoch. Returns lr(step, lr_scale), in f32 as
    the JAX step computes it."""
    policy = cfg.lr_policy
    base_lr = np.float32(cfg.lr)
    spe = max(int(getattr(cfg, "steps_per_epoch", 0)), 1)
    n_epochs, n_decay = cfg.n_epochs, cfg.n_epochs_decay
    epoch_count = cfg.epoch_count
    decay_iters = max(cfg.lr_decay_iters, 1)
    if policy not in ("linear", "step", "cosine", "plateau"):
        raise ValueError(f"unknown lr_policy {policy!r}")

    def lr_fn(step: int, lr_scale: float) -> float:
        e = np.float32(step // spe)
        if policy == "linear":
            over = np.maximum(np.float32(0.0), e + np.float32(epoch_count - n_epochs))
            factor = np.float32(1.0) - over / np.float32(n_decay + 1)
        elif policy == "step":
            factor = np.float32(0.1) ** np.floor(e / np.float32(decay_iters))
        elif policy == "cosine":
            factor = np.float32(0.5) * (
                np.float32(1.0) + np.cos(np.float32(math.pi) * e / np.float32(n_epochs))
            )
        else:
            factor = np.float32(1.0)  # the training loop updates lr_scale
        return float(base_lr * np.float32(factor) * np.float32(lr_scale))

    return lr_fn


@dataclass
class GANTrainState:
    """The whole training state: step, LR scale, the nets, one optimizer
    per name (e.g. 'G', 'D'), and the replay pools. All of it is
    checkpointed (utils/checkpoint.py)."""

    step: int
    lr_scale: float
    nets: Dict[str, nn.Module]
    opts: Dict[str, Adam]
    pools: Dict = field(default_factory=dict)


def prepare_batch(batch, generator: Optional[torch.Generator], cfg, train: bool = True):
    """Standardize A and B with the per-variable stats the dataset sent
    along (climate data), then, in training with --in_graph_aug, flip and
    roll the pair with shared draws (``in_step_augment``). Under spatial
    sharding every rank prepares the same global batch, with the same
    draws, and then takes its W shard (``shard_batch``): flip and roll are
    not local to a shard (JAX parallel/spatial.py:185-214)."""
    out = dict(batch)
    for k in ("A", "B"):
        mk, sk = f"{k}_mean", f"{k}_std"
        if k in out and mk in out:
            out[k] = standardize(out[k], out[mk][0], out[sk][0])
            del out[mk], out[sk]
    if train and getattr(cfg, "in_graph_aug", False):
        out = in_step_augment(
            out, generator, flip=not cfg.no_flip, lon_roll=getattr(cfg, "aug_lon_roll", False)
        )
    return out


def shard_batch(batch, ctx):
    """This rank's W shard of every NHWC field of the batch (the rest as it
    is)."""
    return {k: shard_w(v, ctx) if getattr(v, "ndim", 0) == 4 else v for k, v in batch.items()}


def resolve_direction(batch, direction: str):
    """--direction AtoB | BtoA picks (source, target)."""
    if direction == "AtoB":
        return batch["A"], batch["B"]
    if direction == "BtoA":
        return batch["B"], batch["A"]
    raise ValueError(f"unknown direction {direction!r}")


def device_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    """A generator on ``device`` seeded by one draw from the CPU
    ``generator`` (the step's): the source of the step's dropout masks."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws (augmentation, pools), derived
    from (--seed, step) alone, so a resumed run draws what an uninterrupted
    one does."""
    return torch.Generator().manual_seed(int(seed) * 1_000_003 + int(step))


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """Data rank ``rank``'s own CPU generator in a step whose shared draws
    come from ``generator`` (``step_generator``'s): seeded from that
    generator's seed and the rank, so it draws nothing from the shared
    stream, and a seed gives the same run and a resume the same draws. The
    JAX step folds the data index into its key likewise
    (``jax.random.fold_in``) for dropout, augmentation and the penalty."""
    seed = (generator.initial_seed() * 1_000_033 + int(rank) + 1) % (1 << 63)
    return torch.Generator().manual_seed(seed)
