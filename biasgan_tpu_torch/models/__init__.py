"""Model registry entries.

Counterpart of the registrations in ``biasgan_tpu/models/`` (pix2pix,
cycle_gan, test). An entry carries the model's reference default flags,
which generator checkpoint ``<epoch>_net_<name>.pth`` inference loads, and,
for a model the port trains (pix2pix, cycle_gan), its training state and
step (``create_state``, ``make_train_step``, ``loss_names``) and its G
forwards for evaluation (``make_eval_fn``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from biasgan_tpu_torch.models import cyclegan, pix2pix
from biasgan_tpu_torch.registry import register_model


@dataclass
class TestModelConfig:
    model_suffix: str = ""  # reference: load "G<suffix>" (e.g. '_A' from CycleGAN)


@register_model("pix2pix", pix2pix.Pix2PixConfig)
class Pix2PixModel:
    loss_names = pix2pix.LOSS_NAMES
    create_state = staticmethod(pix2pix.create_state)
    make_train_step = staticmethod(pix2pix.make_train_step)
    make_eval_fn = staticmethod(pix2pix.make_eval_fn)
    check_sharded = staticmethod(pix2pix.check_sharded)

    @staticmethod
    def config_defaults(train: bool) -> Dict[str, Any]:
        # reference Pix2PixModel.modify_commandline_options
        d = {"norm": "batch", "netG": "unet_256", "dataset_mode": "aligned"}
        if train:
            d.update({"pool_size": 0, "gan_mode": "vanilla"})
        return d

    @staticmethod
    def generator_name(cfg) -> str:
        return "G"


@register_model("cycle_gan", cyclegan.CycleGANConfig)
class CycleGANModel:
    loss_names = cyclegan.LOSS_NAMES
    create_state = staticmethod(cyclegan.create_state)
    make_train_step = staticmethod(cyclegan.make_train_step)
    make_eval_fn = staticmethod(cyclegan.make_eval_fn)

    @staticmethod
    def config_defaults(train: bool) -> Dict[str, Any]:
        # reference CycleGANModel.modify_commandline_options
        d = {
            "norm": "instance",
            "netG": "resnet_9blocks",
            "no_dropout": True,
            "dataset_mode": "unaligned",
        }
        if train:
            d.update({"gan_mode": "lsgan", "pool_size": 50})
        return d

    @staticmethod
    def generator_name(cfg) -> str:
        # G_A maps A->B, G_B maps B->A (reference --direction semantics)
        return "G_B" if cfg.direction == "BtoA" else "G_A"


@register_model("test", TestModelConfig)
class TestModel:
    @staticmethod
    def config_defaults(train: bool) -> Dict[str, Any]:
        if train:
            raise ValueError("TestModel is test-time only (reference semantics)")
        return {"dataset_mode": "single"}

    @staticmethod
    def generator_name(cfg) -> str:
        return "G" + cfg.model_suffix
