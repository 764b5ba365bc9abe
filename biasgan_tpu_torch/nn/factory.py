"""Network factory — counterpart of ``define_G`` in
``biasgan_tpu/nn/factory.py`` (the reference's models/networks.py).

Torch modules need their input width at construction, so ``define_G`` takes
``input_nc`` where the JAX factory infers it at init. Weights are drawn at
construction from ``generator`` (a ``torch.Generator``; None = torch's
global one).
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

from biasgan_tpu_torch.nn.generators import ResNetGenerator

_UNET_NAMES = ("unet_256", "unet_128", "unet_64", "unet_32")

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
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build a generator module by name: resnet_9blocks | resnet_6blocks |
    resnet_<K>blocks. ``w_mode`` overrides width-axis padding ('wrap' =
    periodic longitude). ``fused_blocks``, ``fused_updown``, ``conv7`` and
    ``fused_norm`` route the resnet's layers through the hand-written
    kernels (``ResNetGenerator``). The U-Net names are not ported yet."""
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
            generator=generator,
        )
    if netG in _UNET_NAMES or re.fullmatch(r"unet_d(\d+)", netG):
        raise NotImplementedError(
            f"generator {netG!r} is not yet ported to biasgan_tpu_torch "
            "(the U-Net arrives with the pix2pix training slice)"
        )
    raise ValueError(f"unknown generator name {netG!r}")
