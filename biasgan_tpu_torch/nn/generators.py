"""ResNet generator (the CycleGAN / full-globe generator).

Counterpart of ``ResNetBlock`` and ``ResNetGenerator`` in
``biasgan_tpu/nn/generators.py``, whole-forward form (the JAX package's
``stage='all'``). Channel schedule, norm placement, bias rules and padding
follow it; module names follow the torch oracle of
tests/unit/test_torch_parity.py (``stem``, ``down0``, ``down1``,
``blocks.{i}.conv{0,1}``, ``up0``, ``up1``, ``head``, and the batch-norm
``*_norm*`` modules), so ``utils/torch_import.py::convert_state_dict`` maps
port weights onto reference params.

The fused block path runs the 18 block convs through the hand-written
``conv3x3_fused`` kernel (kernels/conv3x3_fused.py): SAME pad in the kernel,
norm0 + ReLU as conv1's prologue, the instance-norm moments emitted by the
kernel, so the normalized activation and the pad copies never round-trip
device memory. Only the closing norm1 affine + residual add is a separate
elementwise pass.

Three more routes follow the JAX generator's opt-in kernel paths:

* ``fused_updown`` (with the fused block path engaged) runs the two
  downsampling convs through ``conv3x3s2_fused`` and the two upsampling
  conv-transposes through ``convt3x3s2_fused``: the stem's instance norm +
  ReLU becomes down0's prologue (from the f32 moments of the stem output),
  down0's becomes down1's, up0's becomes up1's, and only down1's and up1's
  norms run as one affine + ReLU pass each (generators.py:409-458,
  512-531);
* ``conv7`` runs the 7x7 stem and head through ``conv7x7``;
* ``fused_norm`` runs every ``norm_act`` that remains on the path through
  ``instance_norm_act`` (instance norm only).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from biasgan_tpu_torch.kernels.common import stored_moments
from biasgan_tpu_torch.kernels.conv3x3_fused import (
    apply_affine,
    instance_moments_to_affine,
)
from biasgan_tpu_torch.nn.layers import (
    Conv2d,
    ConvTranspose2d,
    make_norm,
    norm_act,
    norm_uses_bias,
)


def fused_blocks_blocker(
    norm_type: str, use_dropout: bool, training: bool
) -> Optional[str]:
    """Why the fused block path cannot engage, or None when it can:
    instance norm, no dropout, eval mode (the JAX gate,
    generators.py:309-316; training needs the backward kernel, which is not
    ported yet)."""
    if norm_type != "instance":
        return f"norm {norm_type!r} is not instance norm"
    if use_dropout:
        return "dropout is on (pass --no_dropout)"
    if training:
        return "the generator is in training mode"
    return None


class ResNetBlock(nn.Module):
    """Reference ``ResnetBlock``: reflect-pad 3x3 conv, norm, relu,
    [dropout], reflect-pad 3x3 conv, norm, residual add."""

    def __init__(
        self,
        dim: int,
        norm_type: str = "instance",
        use_dropout: bool = False,
        w_mode: str = "reflect",
        init_type: str = "normal",
        init_gain: float = 0.02,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        use_bias = norm_uses_bias(norm_type)

        def conv() -> Conv2d:
            return Conv2d(
                dim, dim, (3, 3), padding=(1, 1), use_bias=use_bias,
                h_mode="reflect", w_mode=w_mode, init_type=init_type,
                init_gain=init_gain, compute_dtype=compute_dtype,
                generator=generator,
            )

        self.conv0 = conv()
        self.norm0 = make_norm(norm_type, dim, compute_dtype, generator)
        self.dropout = nn.Dropout(0.5) if use_dropout else None
        self.conv1 = conv()
        self.norm1 = make_norm(norm_type, dim, compute_dtype, generator)

    def forward(
        self, x: torch.Tensor, fused: bool = False, fused_norm: bool = False
    ) -> torch.Tensor:
        if fused:
            # generators.py:253-264: conv0 -> moments -> affine -> conv1's
            # prologue -> moments -> affine + residual
            count = x.shape[1] * x.shape[2]
            y0, m0 = self.conv0.forward_fused(x)
            a0, b0 = instance_moments_to_affine(*m0, count)
            y1, m1 = self.conv1.forward_fused(y0, prologue=(a0, b0))
            a1, b1 = instance_moments_to_affine(*m1, count)
            return apply_affine(y1, a1, b1) + x
        h = norm_act(self.conv0(x), self.norm0, activation="relu", fused=fused_norm)
        if self.dropout is not None:
            h = self.dropout(h)
        return norm_act(self.conv1(h), self.norm1, residual=x, fused=fused_norm)


class ResNetGenerator(nn.Module):
    """Reference ``ResnetGenerator``: 7x7 stem, 2x stride-2 down, ``n_blocks``
    residual blocks, 2x stride-2 conv-transpose up, 7x7 head + tanh.
    resnet_9blocks <=> n_blocks=9. Input and output are NHWC.

    ``fused_blocks`` routes the residual blocks through the conv3x3_fused
    kernel whenever ``fused_blocks_blocker`` allows it (checked per
    forward, since it depends on train/eval mode). ``fused_updown`` adds
    the fused down and up convs where the block path is engaged (the down
    path also needs the input's H and W divisible by 4); ``conv7`` and
    ``fused_norm`` route the 7x7 convs and the remaining norms (module
    docstring). All four are plain attributes, read per forward."""

    def __init__(
        self,
        input_nc: int,
        output_nc: int,
        ngf: int = 64,
        n_blocks: int = 9,
        norm_type: str = "instance",
        use_dropout: bool = False,
        out_activation: str = "tanh",
        w_mode: str = "reflect",
        init_type: str = "normal",
        init_gain: float = 0.02,
        compute_dtype: Optional[torch.dtype] = None,
        fused_blocks: bool = False,
        fused_updown: bool = False,
        conv7: bool = False,
        fused_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.norm_type = norm_type
        self.use_dropout = use_dropout
        self.out_activation = out_activation
        self.fused_blocks = fused_blocks
        self.fused_updown = fused_updown
        self.conv7 = conv7
        self.fused_norm = fused_norm
        use_bias = norm_uses_bias(norm_type)
        common = dict(
            init_type=init_type, init_gain=init_gain,
            compute_dtype=compute_dtype, generator=generator,
        )
        zero_w = "wrap" if w_mode == "wrap" else "zero"

        def norm(ch: int) -> nn.Module:
            return make_norm(norm_type, ch, compute_dtype, generator)

        self.stem = Conv2d(
            input_nc, ngf, (7, 7), padding=(3, 3), use_bias=use_bias,
            h_mode="reflect", w_mode=w_mode, **common,
        )
        self.stem_norm = norm(ngf)
        # downsample (zero H padding, reference semantics)
        self.down0 = Conv2d(
            ngf, ngf * 2, (3, 3), stride=(2, 2), padding=(1, 1),
            use_bias=use_bias, w_mode=zero_w, **common,
        )
        self.down_norm0 = norm(ngf * 2)
        self.down1 = Conv2d(
            ngf * 2, ngf * 4, (3, 3), stride=(2, 2), padding=(1, 1),
            use_bias=use_bias, w_mode=zero_w, **common,
        )
        self.down_norm1 = norm(ngf * 4)
        self.blocks = nn.ModuleList(
            ResNetBlock(
                ngf * 4, norm_type=norm_type, use_dropout=use_dropout,
                w_mode=w_mode, **common,
            )
            for _ in range(n_blocks)
        )
        self.up0 = ConvTranspose2d(
            ngf * 4, ngf * 2, (3, 3), stride=(2, 2), padding=(1, 1),
            output_padding=(1, 1), use_bias=use_bias, w_mode=zero_w, **common,
        )
        self.up_norm0 = norm(ngf * 2)
        self.up1 = ConvTranspose2d(
            ngf * 2, ngf, (3, 3), stride=(2, 2), padding=(1, 1),
            output_padding=(1, 1), use_bias=use_bias, w_mode=zero_w, **common,
        )
        self.up_norm1 = norm(ngf)
        self.head = Conv2d(
            ngf, output_nc, (7, 7), padding=(3, 3), use_bias=True,
            h_mode="reflect", w_mode=w_mode, **common,
        )

    def fused_engaged(self) -> bool:
        return self.fused_blocks and fused_blocks_blocker(
            self.norm_type, self.use_dropout, self.training
        ) is None

    def updown_engaged(self, x: torch.Tensor) -> tuple:
        """(down, up): whether the fused down and up paths run for stem
        input ``x`` (the JAX gate ``_fused_updown_plans``,
        generators.py:333-383, less its TPU tiling conditions)."""
        up = self.fused_updown and self.fused_engaged()
        return up and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0, up

    def _norm_act(self, h, norm, **kw):
        return norm_act(h, norm, fused=self.fused_norm, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused_down, fused_up = self.updown_engaged(x)
        h = self.stem(x, conv7=self.conv7)
        if fused_down:
            # the stem's norm + ReLU rides into down0, down0's into down1
            count = h.shape[1] * h.shape[2]
            a, b = instance_moments_to_affine(*stored_moments(h), count)
            for down in (self.down0, self.down1):
                h, m = down.forward_fused_s2(h, prologue=(a, b))
                a, b = instance_moments_to_affine(*m, h.shape[1] * h.shape[2])
            h = apply_affine(h, a, b, relu=True)
        else:
            h = self._norm_act(h, self.stem_norm, activation="relu")
            h = self._norm_act(self.down0(h), self.down_norm0, activation="relu")
            h = self._norm_act(self.down1(h), self.down_norm1, activation="relu")
        fused = self.fused_engaged()
        for block in self.blocks:
            h = block(h, fused=fused, fused_norm=self.fused_norm)
        if fused_up:
            # up0's norm + ReLU rides into up1
            prologue = None
            for up in (self.up0, self.up1):
                h, m = up.forward_fused(h, prologue=prologue)
                prologue = instance_moments_to_affine(*m, h.shape[1] * h.shape[2])
            h = apply_affine(h, *prologue, relu=True)
        else:
            h = self._norm_act(self.up0(h), self.up_norm0, activation="relu")
            h = self._norm_act(self.up1(h), self.up_norm1, activation="relu")
        h = self.head(h, conv7=self.conv7).float()
        return torch.tanh(h) if self.out_activation == "tanh" else h
