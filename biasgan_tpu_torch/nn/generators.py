"""The generators: the U-Net (pix2pix) and the ResNet (CycleGAN, the
full globe).

``UNetGenerator`` is the counterpart of ``UNetGenerator`` in
``biasgan_tpu/nn/generators.py`` (:50-133), module names those of the torch
oracle (``downs.{i}``, ``down_norms.{i}``, ``ups.{i}``, ``up_norms.{i}``;
``biasgan_tpu/utils/torch_import.py:28-37``). It runs no hand-written
kernel: the JAX U-Net reaches no Pallas kernel (its 4x4 stride-2 convs and
conv-transposes and its norms pass no kernel gate), so its convs are cuDNN's
here.

The ResNet is the counterpart of ``ResNetBlock`` and ``ResNetGenerator`` in
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
elementwise pass. In training the same convs run ``conv3x3_fused_t``, the
kernel with its exact backward (the JAX ``fused_diff`` path).

Four more routes follow the JAX generator's opt-in kernel paths:

* ``pallas_conv`` (where the fused block path is off) runs the 18 block
  convs through ``conv3x3_valid`` on the padded input, and in training
  their input gradients too (``conv3x3_op``);
* ``fused_updown`` (with the fused block path engaged, inference only, as
  the JAX gate ``generators.py:342``) runs the two
  downsampling convs through ``conv3x3s2_fused`` and the two upsampling
  conv-transposes through ``convt3x3s2_fused``: the stem's instance norm +
  ReLU becomes down0's prologue (from the f32 moments of the stem output),
  down0's becomes down1's, up0's becomes up1's, and only down1's and up1's
  norms run as one affine + ReLU pass each (generators.py:409-458,
  512-531);
* ``conv7`` runs the 7x7 stem and head through ``conv7x7``;
* ``fused_norm`` runs every ``norm_act`` that remains on the path through
  ``instance_norm_act`` (instance norm only).

``forward(x, ctx=...)`` runs this rank's W shard of a spatially sharded
forward (``parallel.spatial``): the W pads come by halo exchange, the
instance norms' statistics are global over W, and of the routes only the
fused block path engages, in the conv kernel's halo W mode with the moments
summed over the shards (JAX generators.py:192-249), in training as in eval;
the others are off, as the JAX gates turn them off under a context.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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
from biasgan_tpu_torch.trace import span


def _check_spatial(ctx, w: int, stride: int, where: str) -> None:
    """A sharded local width must divide by the stride that follows (JAX
    generators.py:42-47)."""
    if ctx is not None and w % stride != 0:
        raise ValueError(
            f"{where}: sharded local width {w} not divisible by stride {stride}; "
            "pad the global field to a multiple of n_shards * 2^n_downsamples"
        )


class UNetGenerator(nn.Module):
    """Reference ``UnetGenerator``: ``num_downs`` 4x4 stride-2 convs down to
    a bottleneck (down channels ``min(2^i, 8) * ngf``; down0 without
    pre-activation or norm, the innermost down without norm), mirrored by
    4x4 stride-2 conv-transposes with skip concatenation ``cat([d_i, u])``
    (input first), conv biases only where the norm is not batch norm (always
    on the outermost up), output cast to f32, then tanh (or 'none').
    unet_256 <=> num_downs 8. Input and output are NHWC.

    ``use_dropout``: Dropout(0.5) (flax's: kept values scaled by 2) after
    the norm of each up block i with ``dc[i] == dc[i-1] == 8 ngf``, the
    ``num_downs - 5`` intermediate 8 ngf blocks, in training mode only; its
    masks are drawn on the device from the ``generator`` the forward is
    given (the step's), never from torch's global stream.

    ``w_mode``: the downs' W pad ('zero', or 'wrap' for periodic
    longitude); the conv-transposes wrap when it wraps. Under a spatial
    context ``ctx`` (this rank's W shard) every conv pads W by halo
    exchange, the instance norms take W-global statistics and batch norm
    normalizes by its running averages (in training it raises)."""

    def __init__(
        self,
        input_nc: int,
        output_nc: int,
        ngf: int = 64,
        num_downs: int = 8,
        norm_type: str = "batch",
        use_dropout: bool = False,
        out_activation: str = "tanh",
        w_mode: str = "zero",
        init_type: str = "normal",
        init_gain: float = 0.02,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        D = self.num_downs = num_downs
        self.out_activation = out_activation
        use_bias = norm_uses_bias(norm_type)
        common = dict(init_type=init_type, init_gain=init_gain,
                      compute_dtype=compute_dtype, generator=generator)
        dc = [min(2**i, 8) * ngf for i in range(D)]
        up_w = "wrap" if w_mode == "wrap" else "zero"

        def norm(ch: int) -> nn.Module:
            return make_norm(norm_type, ch, compute_dtype, generator)

        def up(cin: int, cout: int, bias: bool) -> ConvTranspose2d:
            return ConvTranspose2d(cin, cout, (4, 4), stride=(2, 2), padding=(1, 1),
                                   use_bias=bias, w_mode=up_w, **common)

        self.downs = nn.ModuleList()
        self.down_norms = nn.ModuleDict()
        prev = input_nc
        for i in range(D):
            self.downs.append(Conv2d(prev, dc[i], (4, 4), stride=(2, 2), padding=(1, 1),
                                     use_bias=use_bias, w_mode=w_mode, **common))
            if 0 < i < D - 1:
                self.down_norms[str(i)] = norm(dc[i])
            prev = dc[i]
        # ups[i] makes level i: from the innermost down's output alone at
        # i = D - 1, else from the skip concatenation of level i + 1
        self.ups = nn.ModuleList(
            [up(2 * dc[0], output_nc, True)]
            + [up(2 * dc[i], dc[i - 1], use_bias) for i in range(1, D - 1)]
            + [up(dc[D - 1], dc[D - 2], use_bias)])
        self.up_norms = nn.ModuleDict({str(i): norm(dc[i - 1]) for i in range(1, D)})
        self.drop_at = {i for i in range(1, D - 1)
                        if use_dropout and dc[i] == dc[i - 1] == 8 * ngf}

    def forward(self, x: torch.Tensor, ctx=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        D = self.num_downs
        with span("port.G.down"):
            _check_spatial(ctx, x.shape[2], 2, "unet down0")
            d = [self.downs[0](x, ctx=ctx)]
            for i in range(1, D):
                _check_spatial(ctx, d[-1].shape[2], 2, f"unet down{i}")
                h = self.downs[i](F.leaky_relu(d[-1], negative_slope=0.2), ctx=ctx)
                if i < D - 1:
                    h = norm_act(h, self.down_norms[str(i)], ctx=ctx)
                d.append(h)
        with span("port.G.up"):
            u = norm_act(self.ups[D - 1](F.relu(d[D - 1]), ctx=ctx), self.up_norms[str(D - 1)],
                         ctx=ctx)
            for i in range(D - 2, 0, -1):
                u = self.ups[i](F.relu(torch.cat([d[i], u], dim=-1)), ctx=ctx)
                u = norm_act(u, self.up_norms[str(i)], ctx=ctx)
                if i in self.drop_at and self.training:
                    u = dropout(u, 0.5, generator, ctx)
            u = self.ups[0](F.relu(torch.cat([d[0], u], dim=-1)), ctx=ctx).float()
            return torch.tanh(u) if self.out_activation == "tanh" else u


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            ctx=None) -> torch.Tensor:
    """flax ``Dropout(rate)`` in training: each value kept with probability
    1 - rate and scaled by 1 / (1 - rate), else 0. The mask is drawn on x's
    device from ``generator``, which must be given and live there. Under a
    spatial context ``ctx`` (x this rank's W shard) every rank draws the
    whole-W mask from the same generator and keeps its shard's columns, so
    the sharded forward drops what the whole-field forward does (JAX draws
    a mask per shard from one key: a deliberate difference)."""
    if generator is None:
        raise ValueError("dropout in training needs the step's torch.Generator")
    shape = list(x.shape)
    if ctx is not None:  # x is NHWC: the whole W's mask
        w = shape[2]
        shape[2] *= ctx.n_shards
    keep = torch.empty(shape, device=x.device).bernoulli_(1.0 - rate, generator=generator)
    if ctx is not None:
        keep = keep[:, :, ctx.rank * w:(ctx.rank + 1) * w]
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def fused_blocks_blocker(norm_type: str, use_dropout: bool) -> Optional[str]:
    """Why the fused block path cannot engage, or None when it can:
    instance norm and no dropout (the JAX gate, generators.py:309-316). It
    engages in training as in eval: training runs the differentiable
    ``conv3x3_fused_t``."""
    if norm_type != "instance":
        return f"norm {norm_type!r} is not instance norm"
    if use_dropout:
        return "dropout is on (pass --no_dropout)"
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
        self.use_dropout = use_dropout
        self.conv1 = conv()
        self.norm1 = make_norm(norm_type, dim, compute_dtype, generator)

    def forward(
        self,
        x: torch.Tensor,
        fused: bool = False,
        fused_norm: bool = False,
        pallas_conv: bool = False,
        ctx=None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if fused and ctx is not None:
            return self._forward_fused_sharded(x, ctx)
        if fused:
            # generators.py:253-264: conv0 -> moments -> affine -> conv1's
            # prologue -> moments -> affine + residual
            count = x.shape[1] * x.shape[2]
            y0, m0 = self.conv0.forward_fused(x)
            a0, b0 = instance_moments_to_affine(*m0, count)
            y1, m1 = self.conv1.forward_fused(y0, prologue=(a0, b0))
            a1, b1 = instance_moments_to_affine(*m1, count)
            return apply_affine(y1, a1, b1) + x
        h = self.conv0(x, pallas_conv=pallas_conv, ctx=ctx)
        h = norm_act(h, self.norm0, activation="relu", fused=fused_norm, ctx=ctx)
        if self.use_dropout and self.training:
            h = dropout(h, 0.5, generator, ctx)
        h = self.conv1(h, pallas_conv=pallas_conv, ctx=ctx)
        return norm_act(h, self.norm1, residual=x, fused=fused_norm, ctx=ctx)

    def _forward_fused_sharded(self, x: torch.Tensor, ctx) -> torch.Tensor:
        """The fused block on this rank's W shard (JAX generators.py:
        192-249): each conv takes its W pad columns from the ring
        neighbours (the kernel's halo mode), and the moments are summed over
        the shards, so the affine is W-global."""
        count = x.shape[1] * x.shape[2] * ctx.n_shards

        def exchange(h, edge_raw=None):
            # A non-periodic global edge column is zero AFTER the prologue
            # in the whole-field path, but the halo carries RAW conv output,
            # so it gets the pre-image of that zero, the instance mean -b/a
            # (ReLU keeps the 0), cast to h's dtype: in bf16 a seam of
            # ~0.4% of |b| on the two global edge columns only. Out of
            # place and on every rank (the mask is all false between the
            # edges): the fill stays differentiable, to a0 and b0, and every
            # rank records the same operations, so the collectives of the
            # backward pair up.
            hp = ctx.pad_w(h, 1, 1)
            if edge_raw is not None and not ctx.periodic:
                w = hp.shape[2]
                cols = torch.arange(w, device=hp.device)
                edge = ((cols == 0) & (ctx.rank == 0)) | (
                    (cols == w - 1) & (ctx.rank == ctx.n_shards - 1))
                hp = torch.where(edge[None, None, :, None],
                                 edge_raw[:, None, None, :].to(hp.dtype), hp)
            return hp

        y0, m0 = self.conv0.forward_fused(exchange(x), halo=True)
        a0, b0 = instance_moments_to_affine(*ctx.sum_w(torch.stack(m0)), count)
        y1, m1 = self.conv1.forward_fused(exchange(y0, -b0 / a0), prologue=(a0, b0),
                                          halo=True)
        a1, b1 = instance_moments_to_affine(*ctx.sum_w(torch.stack(m1)), count)
        return apply_affine(y1, a1, b1) + x


class ResNetGenerator(nn.Module):
    """Reference ``ResnetGenerator``: 7x7 stem, 2x stride-2 down, ``n_blocks``
    residual blocks, 2x stride-2 conv-transpose up, 7x7 head + tanh.
    resnet_9blocks <=> n_blocks=9. Input and output are NHWC.

    ``fused_blocks`` routes the residual blocks through the conv3x3_fused
    kernel whenever ``fused_blocks_blocker`` allows it, in training and in
    eval. ``pallas_conv`` routes the block convs through the VALID 3x3
    kernel where the fused path is off. ``fused_updown`` adds the fused
    down and up convs where the block path is engaged in eval mode (the
    down path also needs the input's H and W divisible by 4); ``conv7`` and
    ``fused_norm`` route the 7x7 convs and the remaining norms (module
    docstring). All five are plain attributes, read per forward."""

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
        pallas_conv: bool = False,
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
        self.pallas_conv = pallas_conv
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
            self.norm_type, self.use_dropout
        ) is None

    def updown_engaged(self, x: torch.Tensor) -> tuple:
        """(down, up): whether the fused down and up paths run for stem
        input ``x`` (the JAX gate ``_fused_updown_plans``,
        generators.py:333-383, less its TPU tiling conditions): never in
        training mode, as there (their kernels have no backward)."""
        up = self.fused_updown and self.fused_engaged() and not self.training
        return up and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0, up

    def _norm_act(self, h, norm, **kw):
        return norm_act(h, norm, fused=self.fused_norm, **kw)

    def forward(self, x: torch.Tensor, ctx=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC ``x`` -> NHWC output; under a spatial context ``ctx``, this
        rank's W shard of both (module docstring). ``generator``: the
        device generator the blocks' dropout masks come from, in training
        with dropout on (``dropout``)."""
        fused_down, fused_up = self.updown_engaged(x) if ctx is None else (False, False)
        with span("port.G.stem"):
            h = self.stem(x, conv7=self.conv7, ctx=ctx)
        with span("port.G.down"):
            if fused_down:
                # the stem's norm + ReLU rides into down0, down0's into down1
                count = h.shape[1] * h.shape[2]
                a, b = instance_moments_to_affine(*stored_moments(h), count)
                for down in (self.down0, self.down1):
                    h, m = down.forward_fused_s2(h, prologue=(a, b))
                    a, b = instance_moments_to_affine(*m, h.shape[1] * h.shape[2])
                h = apply_affine(h, a, b, relu=True)
            else:
                h = self._norm_act(h, self.stem_norm, activation="relu", ctx=ctx)
                for i, (down, norm) in enumerate(
                    ((self.down0, self.down_norm0), (self.down1, self.down_norm1))
                ):
                    _check_spatial(ctx, h.shape[2], 2, f"resnet down{i}")
                    h = self._norm_act(down(h, ctx=ctx), norm, activation="relu", ctx=ctx)
        with span("port.G.blocks"):
            fused = self.fused_engaged()
            for block in self.blocks:
                h = block(
                    h, fused=fused, fused_norm=self.fused_norm,
                    pallas_conv=self.pallas_conv, ctx=ctx, generator=generator,
                )
        with span("port.G.up"):
            if fused_up:
                # up0's norm + ReLU rides into up1
                prologue = None
                for up in (self.up0, self.up1):
                    h, m = up.forward_fused(h, prologue=prologue)
                    prologue = instance_moments_to_affine(*m, h.shape[1] * h.shape[2])
                h = apply_affine(h, *prologue, relu=True)
            else:
                h = self._norm_act(self.up0(h, ctx=ctx), self.up_norm0, activation="relu",
                                   ctx=ctx)
                h = self._norm_act(self.up1(h, ctx=ctx), self.up_norm1, activation="relu",
                                   ctx=ctx)
        with span("port.G.head"):
            h = self.head(h, conv7=self.conv7, ctx=ctx).float()
            return torch.tanh(h) if self.out_activation == "tanh" else h
