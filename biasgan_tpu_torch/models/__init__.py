"""Model registry entries.

Counterpart of the registrations in ``biasgan_tpu/models/`` (pix2pix,
cycle_gan, test, template). An entry carries the model's reference
default flags; which generator checkpoint ``<epoch>_net_<name>.pth``
inference loads (``generator_name``) and with which output activation
(``out_activation``); the G slots the test driver fills (``test_nets``:
slot -> (checkpoint net name, input channels, output channels)) and its
G forwards (``make_eval_fn``); and, for a model the port trains (pix2pix,
cycle_gan, template), its training state and step (``create_state``,
``make_train_step``, ``loss_names``).
"""

from __future__ import annotations

from typing import Any, Dict

from biasgan_tpu_torch.models import cyclegan, pix2pix, template, test_model
from biasgan_tpu_torch.registry import register_model


class _Entry:
    """What the entries share: G's output activation is --netG_activation."""

    @staticmethod
    def out_activation(cfg) -> str:
        return cfg.netG_activation


@register_model("pix2pix", pix2pix.Pix2PixConfig)
class Pix2PixModel(_Entry):
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

    @staticmethod
    def test_nets(cfg) -> Dict[str, tuple]:
        return {"G": ("G", cfg.input_nc, cfg.output_nc)}


@register_model("cycle_gan", cyclegan.CycleGANConfig)
class CycleGANModel(_Entry):
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

    @staticmethod
    def test_nets(cfg) -> Dict[str, tuple]:
        return {"G_A": ("G_A", cfg.input_nc, cfg.output_nc),
                "G_B": ("G_B", cfg.output_nc, cfg.input_nc)}


@register_model("template", template.TemplateConfig)
class TemplateModel(_Entry):
    loss_names = template.LOSS_NAMES
    create_state = staticmethod(template.create_state)
    make_train_step = staticmethod(template.make_train_step)
    make_eval_fn = staticmethod(template.make_eval_fn)
    check_sharded = staticmethod(template.check_sharded)
    generator_name = staticmethod(Pix2PixModel.generator_name)
    test_nets = staticmethod(Pix2PixModel.test_nets)

    @staticmethod
    def config_defaults(train: bool) -> Dict[str, Any]:
        return {"dataset_mode": "aligned", "netG": "unet_256"}


@register_model("test", test_model.TestModelConfig)
class TestModel:
    make_eval_fn = staticmethod(test_model.make_eval_fn)
    test_nets = staticmethod(test_model.test_nets)

    @staticmethod
    def config_defaults(train: bool) -> Dict[str, Any]:
        if train:
            raise ValueError("TestModel is test-time only (reference semantics)")
        return {"dataset_mode": "single"}

    @staticmethod
    def generator_name(cfg) -> str:
        return "G" + cfg.model_suffix

    @staticmethod
    def out_activation(cfg) -> str:
        # the JAX TestModel builds G with define_G's default, tanh
        return "tanh"
