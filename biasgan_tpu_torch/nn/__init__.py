"""Network zoo of the port: layers, the U-Net and ResNet generators and
the discriminators (counterpart of ``biasgan_tpu/nn``)."""

from biasgan_tpu_torch.nn.discriminators import NLayerDiscriminator, PixelDiscriminator
from biasgan_tpu_torch.nn.factory import compute_dtype_of, define_D, define_G
from biasgan_tpu_torch.nn.generators import ResNetBlock, ResNetGenerator, UNetGenerator
from biasgan_tpu_torch.nn.layers import (
    Conv2d,
    ConvTranspose2d,
    instance_norm,
    pad_hw,
)

__all__ = [
    "Conv2d",
    "ConvTranspose2d",
    "NLayerDiscriminator",
    "PixelDiscriminator",
    "ResNetBlock",
    "ResNetGenerator",
    "UNetGenerator",
    "compute_dtype_of",
    "define_D",
    "define_G",
    "instance_norm",
    "pad_hw",
]
