"""The 'test' model: a trained generator alone, applied one way at test
time (the reference's TestModel). Counterpart of
``biasgan_tpu/models/test_model.py``:

* G only, built as ``infer.build_generator`` builds it (every kernel route
  of the configuration, --fused_updown among them), ending in tanh
  whatever --netG_activation says: the JAX ``TestModel._build_g``
  (:56-69) passes no output activation;
* --model_suffix _A loads the net G_A of a CycleGAN run,
  ``<epoch>_net_G_A.pth``, into the one G slot;
* the forward maps the batch's A to ``fake``, visuals ``real`` and
  ``fake``; in training mode (the test driver without --eval) with batch
  statistics and dropout, and G's running averages as they were (JAX
  :91-110 drops the update).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from biasgan_tpu_torch.models.common import GANTrainState, eval_forward


@dataclass
class TestModelConfig:
    model_suffix: str = ""  # reference: load "G<suffix>" (e.g. '_A' from CycleGAN)


def test_nets(cfg) -> Dict[str, tuple]:
    """The G slot the test driver fills: slot -> (checkpoint net name,
    input channels, output channels)."""
    return {"G": ("G" + cfg.model_suffix, cfg.input_nc, cfg.output_nc)}


def make_eval_fn(cfg):
    """``eval_fn(state, batch, generator=None, train=False, ctx=None) ->
    {"real": A, "fake": G(A)}``; ``train=True``: batch statistics and
    dropout masks from ``generator`` (default ``step_generator(--seed,
    step)``), the running averages left as they were."""

    @torch.no_grad()
    def eval_fn(state: GANTrainState, batch, generator: Optional[torch.Generator] = None,
                train: bool = False, ctx=None):
        real = batch["A"]
        G = state.nets["G"]
        with eval_forward([G], state, cfg, train, generator, real.device) as drop:
            fake = G(real, ctx=ctx, generator=drop)
        return {"real": real, "fake": fake}

    return eval_fn
