"""Network factory — counterpart of ``define_G`` and ``define_D`` in
``biasgan_tpu/nn/factory.py`` (the reference's models/networks.py).

Torch modules need their input width at construction, so ``define_G`` and
``define_D`` take ``input_nc`` where the JAX factory infers it at init. Weights are drawn at
construction from ``generator`` (a ``torch.Generator``; None = torch's
global one).
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

from biasgan_tpu_torch.nn.discriminators import NLayerDiscriminator, PixelDiscriminator
from biasgan_tpu_torch.nn.generators import ResNetGenerator, UNetGenerator

_UNET_DOWNS = {"unet_256": 8, "unet_128": 7, "unet_64": 6, "unet_32": 5}

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> Optional[torch.dtype]:
    """--compute_dtype value -> the conv compute dtype (None = f32 params)."""
    if name not in _DTYPES:
        raise ValueError(f"unknown compute dtype {name!r}; expected {sorted(_DTYPES)}")
    return _DTYPES[name]


def define_G(
    netG: str,
    input_nc: int,
    output_nc: int,
    ngf: int = 64,
    norm: str = "batch",
    use_dropout: bool = False,
    init_type: str = "normal",
    init_gain: float = 0.02,
    w_mode: Optional[str] = None,
    compute_dtype: Optional[torch.dtype] = None,
    out_activation: str = "tanh",
    fused_blocks: bool = False,
    fused_updown: bool = False,
    conv7: bool = False,
    fused_norm: bool = False,
    pallas_conv: bool = False,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build a generator module by name: unet_256 | unet_128 | unet_64 |
    unet_32 (8 / 7 / 6 / 5 downs) | unet_d<K> (K downs) | resnet_9blocks |
    resnet_6blocks | resnet_<K>blocks. ``w_mode`` overrides width-axis
    padding ('wrap' = periodic longitude; unset, the U-Net pads zero and the
    resnet reflects). ``fused_blocks``, ``fused_updown``, ``conv7``,
    ``fused_norm`` and ``pallas_conv`` route the resnet's layers through the
    hand-written kernels (``ResNetGenerator``); the U-Net has no layer they
    take (the JAX U-Net reaches no kernel), and the CLIs say so
    (``infer.routing_notices``, ``train.routing_notices``)."""
    downs = unet_downs(netG)
    if downs is not None:
        return UNetGenerator(
            input_nc=input_nc,
            output_nc=output_nc,
            ngf=ngf,
            num_downs=downs,
            norm_type=norm,
            use_dropout=use_dropout,
            out_activation=out_activation,
            w_mode=w_mode or "zero",
            init_type=init_type,
            init_gain=init_gain,
            compute_dtype=compute_dtype,
            generator=generator,
        )
    m = re.fullmatch(r"resnet_(\d+)blocks", netG)
    if m:
        return ResNetGenerator(
            input_nc=input_nc,
            output_nc=output_nc,
            ngf=ngf,
            n_blocks=int(m.group(1)),
            norm_type=norm,
            use_dropout=use_dropout,
            out_activation=out_activation,
            w_mode=w_mode or "reflect",
            init_type=init_type,
            init_gain=init_gain,
            compute_dtype=compute_dtype,
            fused_blocks=fused_blocks,
            fused_updown=fused_updown,
            conv7=conv7,
            fused_norm=fused_norm,
            pallas_conv=pallas_conv,
            generator=generator,
        )
    raise ValueError(f"unknown generator name {netG!r}")


def unet_downs(netG: str) -> Optional[int]:
    """The U-Net's number of downs for a U-Net name, else None."""
    m = re.fullmatch(r"unet_d(\d+)", netG)
    return int(m.group(1)) if m else _UNET_DOWNS.get(netG)


def generator_downs(netG: str) -> int:
    """The generator's stride-2 downs: a U-Net's count, a resnet's 2."""
    downs = unet_downs(netG)
    return 2 if downs is None else downs


def define_D(
    netD: str,
    input_nc: int,
    ndf: int = 64,
    n_layers_D: int = 3,
    norm: str = "batch",
    init_type: str = "normal",
    init_gain: float = 0.02,
    w_mode: str = "zero",
    compute_dtype: Optional[torch.dtype] = None,
    fused_norm: bool = False,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build a discriminator by name: basic (3-layer PatchGAN) | n_layers |
    pixel — the reference's --netD values. ``fused_norm`` routes its
    instance norms through the ``instance_norm_act`` kernel."""
    common = dict(
        ndf=ndf, norm_type=norm, init_type=init_type, init_gain=init_gain,
        compute_dtype=compute_dtype, fused_norm=fused_norm, generator=generator,
    )
    if netD == "basic":
        return NLayerDiscriminator(input_nc, n_layers=3, w_mode=w_mode, **common)
    if netD == "n_layers":
        return NLayerDiscriminator(input_nc, n_layers=n_layers_D, w_mode=w_mode, **common)
    if netD == "pixel":
        return PixelDiscriminator(input_nc, **common)
    raise ValueError(f"unknown discriminator name {netD!r}")
