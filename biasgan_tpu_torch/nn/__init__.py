"""Network zoo of the port: layers and the ResNet generator (counterpart
of ``biasgan_tpu/nn``)."""

from biasgan_tpu_torch.nn.factory import compute_dtype_of, define_G
from biasgan_tpu_torch.nn.generators import ResNetBlock, ResNetGenerator
from biasgan_tpu_torch.nn.layers import (
    Conv2d,
    ConvTranspose2d,
    instance_norm,
    pad_hw,
)

__all__ = [
    "Conv2d",
    "ConvTranspose2d",
    "ResNetBlock",
    "ResNetGenerator",
    "compute_dtype_of",
    "define_G",
    "instance_norm",
    "pad_hw",
]
