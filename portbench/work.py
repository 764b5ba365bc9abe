"""The bench's own count of the work a field or a step needs, and the
chip's peaks, from the configuration's shapes alone.

A conv counts 2 FLOPs a multiply-add over every tap of every output pixel
(its zero-padded border taps included, as the library computes them); a
transposed conv over every tap of every input pixel (no inserted zeros).
That is the convention of ``torch.utils.flop_counter.FlopCounterMode``,
which the bench's tests hold these counts to. A training step counts the
forward of every network pass, plus the input- and weight-gradient
products of each pass that is back-propagated (an input gradient only
where something upstream needs it). Norms, activations, losses and Adam
are not counted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3
# bandwidth, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


@dataclass(frozen=True)
class Conv:
    """One conv of a network pass, for one sample, over ``pixels``: a
    conv's output pixels, a transposed conv's input pixels."""

    cin: int
    cout: int
    k: int
    pixels: int

    @property
    def flops(self) -> int:
        return 2 * self.cin * self.cout * self.k * self.k * self.pixels


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet_convs(cin: int, cout: int, ngf: int, n_blocks: int, h: int, w: int) -> List[Conv]:
    """The ResNet generator's convs in forward order, for an (h, w) input
    (h and w divisible by 4)."""
    convs = [Conv(cin, ngf, 7, h * w)]
    c = ngf
    for _ in range(2):
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        convs.append(Conv(c, 2 * c, 3, h * w))
        c *= 2
    convs += [Conv(c, c, 3, h * w)] * (2 * n_blocks)
    for _ in range(2):
        convs.append(Conv(c, c // 2, 3, h * w))
        h, w, c = 2 * h, 2 * w, c // 2
    return convs + [Conv(ngf, cout, 7, h * w)]


def unet_convs(cin: int, cout: int, ngf: int, downs: int, h: int, w: int) -> List[Conv]:
    """The U-Net's convs in forward order (downs, then the ups from the
    innermost out), for an (h, w) input."""
    dc = [min(2**i, 8) * ngf for i in range(downs)]
    convs, sizes, prev = [], [], cin
    for i in range(downs):
        h, w = _out(h, 4, 2, 1), _out(w, 4, 2, 1)
        convs.append(Conv(prev, dc[i], 4, h * w))
        sizes.append(h * w)
        prev = dc[i]
    convs.append(Conv(dc[-1], dc[-2], 4, sizes[-1]))
    for i in range(downs - 2, 0, -1):
        convs.append(Conv(2 * dc[i], dc[i - 1], 4, sizes[i]))
    return convs + [Conv(2 * dc[0], cout, 4, sizes[0])]


def basic_d_convs(cin: int, ndf: int, h: int, w: int) -> List[Conv]:
    """The 3-layer PatchGAN's convs, for an (h, w) input."""
    chans = [cin, ndf, 2 * ndf, 4 * ndf, 8 * ndf, 1]
    convs = []
    for n, s in enumerate((2, 2, 2, 1, 1)):
        h, w = _out(h, 4, s, 1), _out(w, 4, s, 1)
        convs.append(Conv(chans[n], chans[n + 1], 4, h * w))
    return convs


def forward_flops(convs: List[Conv]) -> int:
    return sum(c.flops for c in convs)


def pass_flops(convs: List[Conv], batch: int, wgrad: bool, dgrad: bool,
               dgrad_first: bool) -> int:
    """One network pass of ``batch`` samples: its forward, and with
    ``wgrad`` / ``dgrad`` its weight / input gradients (each the forward's
    count); ``dgrad_first``: the first conv's input gradient too (its input
    needs a gradient)."""
    f = forward_flops(convs)
    total = f
    if wgrad:
        total += f
    if dgrad:
        total += f - (0 if dgrad_first else convs[0].flops)
    return batch * total


def generator_convs(cfg, h: int, w: int, cin: int, cout: int) -> List[Conv]:
    if cfg["netG"].startswith("unet"):
        return unet_convs(cin, cout, cfg["ngf"], cfg["unet_downs"], h, w)
    return resnet_convs(cin, cout, cfg["ngf"], cfg["n_blocks"], h, w)


def field_flops(cfg, h: int, w: int) -> int:
    """One served field: the generator's forward on the padded (h, w)."""
    return forward_flops(generator_convs(cfg, h, w, cfg["input_nc"], cfg["output_nc"]))


def pix2pix_step_flops(cfg, batch: int, crop: int) -> int:
    """G forward; D on the fake (detached) and the real pair, both
    back-propagated into D's weights; D on the fake pair again for the G
    step, back to its input; G's backward (its input needs none)."""
    g = generator_convs(cfg, crop, crop, cfg["input_nc"], cfg["output_nc"])
    d = basic_d_convs(cfg["input_nc"] + cfg["output_nc"], cfg["ndf"], crop, crop)
    return (pass_flops(g, batch, True, True, False)
            + 2 * pass_flops(d, batch, True, True, False)
            + pass_flops(d, batch, False, True, True))


def cyclegan_step_flops(cfg, batch: int, crop: int) -> int:
    """G_A on [A; B] (input needs no gradient), G_B on [B; fake_B; A] (it
    does: fake_B), G_A on fake_A (it does); D_A on fake_B and D_B on fake_A
    for the G step, back to their inputs; each D pair [real; pooled fake]
    (detached) back-propagated into the D's weights."""
    g = generator_convs(cfg, crop, crop, cfg["input_nc"], cfg["output_nc"])
    d = basic_d_convs(cfg["output_nc"], cfg["ndf"], crop, crop)
    return (pass_flops(g, 2 * batch, True, True, False)
            + pass_flops(g, 3 * batch, True, True, True)
            + pass_flops(g, batch, True, True, True)
            + 2 * pass_flops(d, batch, False, True, True)
            + 2 * pass_flops(d, 2 * batch, True, True, False))


def step_flops(cfg, batch: int, crop: int) -> int:
    if cfg["model"] == "pix2pix":
        return pix2pix_step_flops(cfg, batch, crop)
    return cyclegan_step_flops(cfg, batch, crop)


def generator_passes(cfg, batch: int) -> List[int]:
    """The batch of each back-propagated generator pass of a step."""
    return [batch] if cfg["model"] == "pix2pix" else [2 * batch, 3 * batch, batch]


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the FLOPs at the
    bf16 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def block_conv_bound_s(n: int, h: int, w: int, c: int) -> float:
    """One resnet block conv, (n, h, w, c) -> c, 3x3, bf16 activations:
    the input read once, the output written once, the bf16 weight, the f32
    bias, prologue (a, b) and output moments (sum, sum^2) once each."""
    flops = 2 * 9 * c * c * n * h * w
    nbytes = 2 * 2 * n * h * w * c + 2 * 9 * c * c + 4 * c + 4 * 4 * n * c
    return bound_s(flops, nbytes)


def block_conv_bwd_bound_s(n: int, h: int, w: int, c: int) -> float:
    """The backward of one resnet block conv with its prologue: the input
    and weight gradients' products (each the forward's count); each input
    (x, the stored y, dy, weight, prologue, moments' cotangents) read once,
    each gradient (dx, dW, dbias, d prologue) written once, activations in
    bf16."""
    flops = 2 * 2 * 9 * c * c * n * h * w
    nbytes = (2 * 4 * n * h * w * c          # x, y, dy read; dx written
              + 2 * 2 * 9 * c * c            # weight read, dW written
              + 4 * (4 * n * c + 2 * n * c)  # a, b, moments' cotangents; da, db
              + 4 * c)                       # dbias
    return bound_s(flops, nbytes)
