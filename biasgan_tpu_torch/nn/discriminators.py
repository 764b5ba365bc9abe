"""Discriminators: the PatchGAN (NLayer) and the 1x1 pixel discriminator.

Counterpart of ``NLayerDiscriminator`` and ``PixelDiscriminator`` in
``biasgan_tpu/nn/discriminators.py`` (:31, :85). Layer schedule, bias rules
and padding follow them; the output is a raw (unsigmoided) logit map that
the GAN loss takes. Module names follow the torch oracle of
tests/unit/test_torch_parity.py (``convs.{n}``, ``norms.{n}``, ``out``), so
``utils/torch_import.py::convert_state_dict`` and ``convert.py`` map them
onto the JAX ``conv{n}`` / ``norm{n}`` / ``conv_out`` params.

``fused_norm`` (a plain attribute, read per forward) sends every instance
norm + LeakyReLU through the ``instance_norm_act`` kernel: the JAX
``--force_pallas_norm`` gate is global, so it reaches the D's norms too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from biasgan_tpu_torch.nn.layers import Conv2d, make_norm, norm_act, norm_uses_bias


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


class NLayerDiscriminator(nn.Module):
    """PatchGAN: 4x4 stride-2 conv stack, norm from layer 2, LeakyReLU(0.2),
    a final 1-channel logit map. n_layers=3 is the reference's 'basic' D.
    Input and output are NHWC."""

    def __init__(
        self,
        input_nc: int,
        ndf: int = 64,
        n_layers: int = 3,
        norm_type: str = "batch",
        w_mode: str = "zero",
        init_type: str = "normal",
        init_gain: float = 0.02,
        compute_dtype: Optional[torch.dtype] = None,
        fused_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.n_layers = n_layers
        self.fused_norm = fused_norm
        use_bias = norm_uses_bias(norm_type)
        common = dict(
            w_mode=w_mode, init_type=init_type, init_gain=init_gain,
            compute_dtype=compute_dtype, generator=generator,
        )

        def conv(cin, cout, stride, bias):
            return Conv2d(cin, cout, (4, 4), stride=(stride, stride), padding=(1, 1),
                          use_bias=bias, **common)

        self.convs = nn.ModuleList([conv(input_nc, ndf, 2, True)])
        self.norms = nn.ModuleDict()
        prev = ndf
        for n in range(1, n_layers):
            ch = ndf * min(2**n, 8)
            self.convs.append(conv(prev, ch, 2, use_bias))
            self.norms[str(n)] = make_norm(norm_type, ch, compute_dtype, generator)
            prev = ch
        ch = ndf * min(2**n_layers, 8)
        self.convs.append(conv(prev, ch, 1, use_bias))
        self.norms[str(n_layers)] = make_norm(norm_type, ch, compute_dtype, generator)
        self.out = conv(ch, 1, 1, True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _lrelu(self.convs[0](x))
        for n in range(1, self.n_layers + 1):
            h = norm_act(self.convs[n](h), self.norms[str(n)], activation="lrelu",
                         fused=self.fused_norm)
        return self.out(h)


class PixelDiscriminator(nn.Module):
    """1x1-conv discriminator: classifies each pixel independently."""

    def __init__(
        self,
        input_nc: int,
        ndf: int = 64,
        norm_type: str = "batch",
        init_type: str = "normal",
        init_gain: float = 0.02,
        compute_dtype: Optional[torch.dtype] = None,
        fused_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.fused_norm = fused_norm
        use_bias = norm_uses_bias(norm_type)
        common = dict(
            init_type=init_type, init_gain=init_gain, compute_dtype=compute_dtype,
            generator=generator,
        )
        self.convs = nn.ModuleList([
            Conv2d(input_nc, ndf, (1, 1), use_bias=True, **common),
            Conv2d(ndf, ndf * 2, (1, 1), use_bias=use_bias, **common),
        ])
        self.norms = nn.ModuleDict(
            {"1": make_norm(norm_type, ndf * 2, compute_dtype, generator)}
        )
        self.out = Conv2d(ndf * 2, 1, (1, 1), use_bias=use_bias, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _lrelu(self.convs[0](x))
        h = norm_act(self.convs[1](h), self.norms["1"], activation="lrelu",
                     fused=self.fused_norm)
        return self.out(h)
