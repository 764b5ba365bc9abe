"""The validation metrics of a training run and the plateau LR policy.

Counterpart of the metric and plateau half of ``biasgan_tpu/models/base.py``
(``compute_validation_metrics`` :256-273, ``evaluate_metrics_on``
:220-254, ``update_learning_rate`` :290-306), as plain functions of the
training state: the port has no model object around its step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from biasgan_tpu_torch.ops.metrics import validation_metrics

# torch ReduceLROnPlateau(factor=0.2, threshold=0.01, patience=5), as the
# JAX package runs it on the host
PLATEAU_FACTOR, PLATEAU_THRESHOLD, PLATEAU_PATIENCE = 0.2, 0.01, 5


@torch.no_grad()
def validation_metrics_of(visuals, cfg, ctx=None, data=None) -> Dict[str, float]:
    """The metric bundle of the visuals' fake_B against real_B (rmse, bias,
    pdf_tv, log_spectral_distance, as floats; {} without them), of the
    global batch on every rank: under a spatial context ``ctx`` the W
    shards are gathered first, under a data context ``data`` the ranks'
    slices. So pdf_tv and the log-spectral distance are the global batch's,
    not means of per-rank values. Collective under either context."""
    fake, real = visuals.get("fake_B"), visuals.get("real_B")
    if fake is None or real is None:
        return {}
    if ctx is not None:
        fake, real = ctx.all_gather_w(fake), ctx.all_gather_w(real)
    if data is not None:
        fake, real = data.all_gather_batch(fake), data.all_gather_batch(real)
    # a tanh G's outputs lie in [-1, 1]; standardized fields (no output
    # activation) are binned over [-5, 5]
    lo, hi = (-1.0, 1.0) if cfg.netG_activation == "tanh" else (-5.0, 5.0)
    return {k: float(v) for k, v in validation_metrics(fake, real, lo, hi).items()}


def evaluate_metrics_on(state, eval_fn, batch, cfg, ctx=None, data=None) -> Dict[str, float]:
    """The metric bundle of an eval-mode forward (running averages, no
    dropout) on ``batch`` (a held-out batch: the global one under a spatial
    context, the rank's slice under a data context): out-of-sample skill.
    It moves no running average and touches no other training state."""
    kw = {} if ctx is None else {"ctx": ctx}
    return validation_metrics_of(eval_fn(state, batch, train=False, **kw), cfg, ctx, data)


def average_metrics(metric_dicts) -> Dict[str, float]:
    """The mean of each metric over name -> float dicts (empty ones
    skipped)."""
    total, count = {}, 0
    for m in metric_dicts:
        if not m:
            continue
        count += 1
        for k, v in m.items():
            total[k] = total.get(k, 0.0) + v
    return {k: v / count for k, v in total.items()} if count else {}


@dataclass
class Plateau:
    """The plateau policy's tracker: the best metric so far and the epochs
    since it improved."""

    best: float = float("inf")
    bad: int = 0


def plateau_update(state, plateau: Plateau, metric) -> None:
    """One epoch's end under --lr_policy plateau: ``metric`` improves when
    it is below best * (1 - 0.01); more than 5 epochs without improvement
    multiply ``state.lr_scale`` by 0.2 (in f32, as the JAX state holds it)
    and start the count again. A metric of None changes nothing."""
    if metric is None:
        return
    if metric < plateau.best * (1 - PLATEAU_THRESHOLD):
        plateau.best, plateau.bad = metric, 0
        return
    plateau.bad += 1
    if plateau.bad > PLATEAU_PATIENCE:
        state.lr_scale = float(np.float32(state.lr_scale) * np.float32(PLATEAU_FACTOR))
        plateau.bad = 0
