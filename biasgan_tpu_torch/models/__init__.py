"""Model registry entries for the inference slice.

Counterpart of the registrations in ``biasgan_tpu/models/`` (pix2pix,
cycle_gan, test). The port does not train yet, so an entry here carries only
what inference reads: the model's reference default flags and which
generator checkpoint ``<epoch>_net_<name>.pth`` to load. The training
options and steps arrive with the training slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from biasgan_tpu_torch.registry import register_model


@dataclass
class TestModelConfig:
    model_suffix: str = ""  # reference: load "G<suffix>" (e.g. '_A' from CycleGAN)


@register_model("pix2pix")
class Pix2PixModel:
    @staticmethod
    def config_defaults(train: bool) -> Dict[str, Any]:
        # reference Pix2PixModel.modify_commandline_options
        return {"norm": "batch", "netG": "unet_256", "dataset_mode": "aligned"}

    @staticmethod
    def generator_name(cfg) -> str:
        return "G"


@register_model("cycle_gan")
class CycleGANModel:
    @staticmethod
    def config_defaults(train: bool) -> Dict[str, Any]:
        # reference CycleGANModel.modify_commandline_options
        return {
            "norm": "instance",
            "netG": "resnet_9blocks",
            "no_dropout": True,
            "dataset_mode": "unaligned",
        }

    @staticmethod
    def generator_name(cfg) -> str:
        # G_A maps A->B, G_B maps B->A (reference --direction semantics)
        return "G_B" if cfg.direction == "BtoA" else "G_A"


@register_model("test", TestModelConfig)
class TestModel:
    @staticmethod
    def config_defaults(train: bool) -> Dict[str, Any]:
        return {"dataset_mode": "single"}

    @staticmethod
    def generator_name(cfg) -> str:
        return "G" + cfg.model_suffix
