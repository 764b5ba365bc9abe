"""Plain PyTorch reference of the bench's networks, in float32.

The networks of the two configurations, written from their published
descriptions (pix2pix, Isola et al. 2017; CycleGAN, Zhu et al. 2017; the
layer schedules of junyanz/pytorch-CycleGAN-and-pix2pix) with plain
``torch.nn.functional`` calls on NCHW tensors: no kernel, no fused chain,
nothing imported from the program under test. Inputs and outputs are NHWC,
as the program's are. Parameters live in one dict keyed by the module
names the program's ``named_parameters`` give, so the harness hands both
sides the same seeded tensors.

Semantics carried over from the configuration, because they move the
numbers:

* padding is explicit per axis: the resnet's 3x3 and 7x7 convs reflect on
  H and take the configuration's W mode (reflect for image training, wrap
  for a periodic-longitude field); strided convs pad with zeros on H and,
  on a periodic W, wrap on W;
* a transposed conv on a periodic W is the circular one: the full
  transposed conv, its output columns folded modulo ``W * stride``;
* batch norm trains on the biased batch variance and moves its running
  averages by ``r = 0.9 r + 0.1 batch`` (flax's momentum, biased variance);
* dropout keeps a value with probability 0.5, scaled by 2, with the mask
  drawn in NHWC order from the generator the step is given.

``quant``, where given, maps every conv's input and weight before the
product (the control of ``check.py``: the same network in fp8).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
EPS = 1e-5


def _pad_axis(x: torch.Tensor, dim: int, p: int, mode: str) -> torch.Tensor:
    if p == 0 or mode == "zero":
        return x
    n = x.shape[dim]
    if mode == "reflect":
        idx = list(range(p, 0, -1)) + list(range(n)) + list(range(n - 2, n - 2 - p, -1))
    elif mode == "wrap":
        idx = [i % n for i in range(-p, n + p)]
    else:
        raise ValueError(mode)
    return x.index_select(dim, torch.tensor(idx, device=x.device))


def conv(x, w, b, stride: int, pad: int, h_mode: str = "zero", w_mode: str = "zero",
         quant: Quant = None):
    """Conv2d on NCHW ``x`` with OIHW ``w``; each axis pads by its mode."""
    x = _pad_axis(_pad_axis(x, 2, pad, h_mode), 3, pad, w_mode)
    zp = (pad if h_mode == "zero" else 0, pad if w_mode == "zero" else 0)
    if quant is not None:
        x, w = quant(x), quant(w)
    y = F.conv2d(x, w, None, stride, zp)
    return y if b is None else y + b.view(1, -1, 1, 1)


def conv_t(x, w, b, stride: int, pad: int, out_pad: int, w_mode: str = "zero",
           quant: Quant = None):
    """ConvTranspose2d on NCHW ``x`` with IOHW ``w``. On a periodic W
    (``w_mode='wrap'``) the output has ``W * stride`` columns and column
    ``f`` of the unpadded transposed conv lands on ``(f - pad) mod W *
    stride``."""
    if quant is not None:
        x, w = quant(x), quant(w)
    if w_mode != "wrap":
        y = F.conv_transpose2d(x, w, None, stride, pad, out_pad)
    else:
        full = F.conv_transpose2d(x, w, None, stride, (pad, 0), (out_pad, 0))
        wout = x.shape[3] * stride
        cols = (torch.arange(full.shape[3], device=x.device) - pad) % wout
        y = full.new_zeros(full.shape[:3] + (wout,)).index_add_(3, cols, full)
    return y if b is None else y + b.view(1, -1, 1, 1)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def batch_norm(x, weight, bias, buffers: Dict[str, torch.Tensor], name: str,
               update: bool) -> torch.Tensor:
    """Training-mode batch norm; moves the running averages in ``buffers``
    when ``update``."""
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    if update:
        with torch.no_grad():
            buffers[name + ".running_mean"] = 0.9 * buffers[name + ".running_mean"] + 0.1 * mean
            buffers[name + ".running_var"] = 0.9 * buffers[name + ".running_var"] + 0.1 * var
    y = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + EPS)
    return y * weight.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# parameter specs: (name, shape, init) in the program's module names
# ---------------------------------------------------------------------------

Spec = List[Tuple[str, Tuple[int, ...], str]]


def resnet_spec(cin: int, cout: int, ngf: int, n_blocks: int) -> Spec:
    s: Spec = [("stem.weight", (ngf, cin, 7, 7), "conv"), ("stem.bias", (ngf,), "bias")]
    for i, (a, b) in enumerate(((ngf, 2 * ngf), (2 * ngf, 4 * ngf))):
        s += [(f"down{i}.weight", (b, a, 3, 3), "conv"), (f"down{i}.bias", (b,), "bias")]
    d = 4 * ngf
    for i in range(n_blocks):
        for j in (0, 1):
            s += [(f"blocks.{i}.conv{j}.weight", (d, d, 3, 3), "conv"),
                  (f"blocks.{i}.conv{j}.bias", (d,), "bias")]
    for i, (a, b) in enumerate(((4 * ngf, 2 * ngf), (2 * ngf, ngf))):
        s += [(f"up{i}.weight", (a, b, 3, 3), "conv"), (f"up{i}.bias", (b,), "bias")]
    return s + [("head.weight", (cout, ngf, 7, 7), "conv"), ("head.bias", (cout,), "bias")]


def unet_channels(ngf: int, downs: int) -> List[int]:
    return [min(2**i, 8) * ngf for i in range(downs)]


def unet_spec(cin: int, cout: int, ngf: int, downs: int) -> Spec:
    """The U-Net with batch norm: no conv bias but the outermost up's."""
    dc = unet_channels(ngf, downs)
    s: Spec = []
    prev = cin
    for i in range(downs):
        s.append((f"downs.{i}.weight", (dc[i], prev, 4, 4), "conv"))
        prev = dc[i]
    s += [("ups.0.weight", (2 * dc[0], cout, 4, 4), "conv"), ("ups.0.bias", (cout,), "bias")]
    for i in range(1, downs - 1):
        s.append((f"ups.{i}.weight", (2 * dc[i], dc[i - 1], 4, 4), "conv"))
    s.append((f"ups.{downs - 1}.weight", (dc[downs - 1], dc[downs - 2], 4, 4), "conv"))
    for i in range(1, downs - 1):
        s += [(f"down_norms.{i}.weight", (dc[i],), "bn_weight"),
              (f"down_norms.{i}.bias", (dc[i],), "bias")]
    for i in range(1, downs):
        s += [(f"up_norms.{i}.weight", (dc[i - 1],), "bn_weight"),
              (f"up_norms.{i}.bias", (dc[i - 1],), "bias")]
    return s


def basic_d_spec(cin: int, ndf: int, norm: str) -> Spec:
    """The 3-layer PatchGAN; conv biases where the norm is not batch norm
    (always on the first and the last conv)."""
    chans = [ndf, 2 * ndf, 4 * ndf, 8 * ndf]
    bias = norm != "batch"
    s: Spec = [("convs.0.weight", (ndf, cin, 4, 4), "conv"), ("convs.0.bias", (ndf,), "bias")]
    for n in range(1, 4):
        s.append((f"convs.{n}.weight", (chans[n], chans[n - 1], 4, 4), "conv"))
        if bias:
            s.append((f"convs.{n}.bias", (chans[n],), "bias"))
        if norm == "batch":
            s += [(f"norms.{n}.weight", (chans[n],), "bn_weight"),
                  (f"norms.{n}.bias", (chans[n],), "bias")]
    return s + [("out.weight", (1, 8 * ndf, 4, 4), "conv"), ("out.bias", (1,), "bias")]


def bn_buffers(spec: Spec, device) -> Dict[str, torch.Tensor]:
    """Initial running averages of every batch norm in ``spec``."""
    out = {}
    for name, shape, init in spec:
        if init == "bn_weight":
            base = name[: -len(".weight")]
            out[base + ".running_mean"] = torch.zeros(shape, device=device)
            out[base + ".running_var"] = torch.ones(shape, device=device)
    return out


def resnet_blocks(netG: str) -> int:
    return int(re.fullmatch(r"resnet_(\d+)blocks", netG).group(1))


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


def resnet_g(P: Dict[str, torch.Tensor], x: torch.Tensor, n_blocks: int, w_mode: str,
             out_activation: str, quant: Quant = None) -> torch.Tensor:
    """The ResNet generator on NHWC ``x``: 7x7 stem, two stride-2 downs,
    ``n_blocks`` residual blocks, two stride-2 transposed ups, 7x7 head;
    instance norm and ReLU after every conv but the head."""
    zw = "wrap" if w_mode == "wrap" else "zero"

    def c(h, name, stride, pad, hm, wm):
        return conv(h, P[name + ".weight"], P[name + ".bias"], stride, pad, hm, wm, quant)

    h = F.relu(instance_norm(c(to_nchw(x), "stem", 1, 3, "reflect", w_mode)))
    for i in range(2):
        h = F.relu(instance_norm(c(h, f"down{i}", 2, 1, "zero", zw)))
    for i in range(n_blocks):
        t = F.relu(instance_norm(c(h, f"blocks.{i}.conv0", 1, 1, "reflect", w_mode)))
        h = h + instance_norm(c(t, f"blocks.{i}.conv1", 1, 1, "reflect", w_mode))
    for i in range(2):
        h = conv_t(h, P[f"up{i}.weight"], P[f"up{i}.bias"], 2, 1, 1, zw, quant)
        h = F.relu(instance_norm(h))
    h = c(h, "head", 1, 3, "reflect", w_mode)
    return to_nhwc(torch.tanh(h) if out_activation == "tanh" else h)


def dropout(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Keep with probability 0.5, scaled by 2; the mask drawn in NHWC order
    on x's device."""
    n, c, h, w = x.shape
    keep = torch.empty((n, h, w, c), device=x.device).bernoulli_(0.5, generator=generator)
    return torch.where(to_nchw(keep).bool(), x / 0.5, 0.0)


def unet_g(P, buffers, x, ngf: int, downs: int, generator: torch.Generator,
           quant: Quant = None) -> torch.Tensor:
    """The U-Net generator in training mode (batch statistics, dropout on
    the three inner 8 ngf up levels, running averages moved), NHWC in and
    out, tanh at the end."""
    dc = unet_channels(ngf, downs)

    def bn(h, name):
        return batch_norm(h, P[name + ".weight"], P[name + ".bias"], buffers, name, True)

    def up(h, i):
        return conv_t(h, P[f"ups.{i}.weight"], P.get(f"ups.{i}.bias"), 2, 1, 0, "zero", quant)

    d = [conv(to_nchw(x), P["downs.0.weight"], None, 2, 1, quant=quant)]
    for i in range(1, downs):
        h = conv(lrelu(d[-1]), P[f"downs.{i}.weight"], None, 2, 1, quant=quant)
        if i < downs - 1:
            h = bn(h, f"down_norms.{i}")
        d.append(h)
    u = bn(up(F.relu(d[-1]), downs - 1), f"up_norms.{downs - 1}")
    for i in range(downs - 2, 0, -1):
        u = bn(up(F.relu(torch.cat([d[i], u], 1)), i), f"up_norms.{i}")
        if dc[i] == dc[i - 1] == 8 * ngf:
            u = dropout(u, generator)
    return to_nhwc(torch.tanh(up(F.relu(torch.cat([d[0], u], 1)), 0)))


def basic_d(P, buffers, x, norm: str, update_stats: bool = True,
            quant: Quant = None) -> torch.Tensor:
    """The 3-layer PatchGAN on NHWC ``x``: its raw logit map (NCHW)."""
    h = lrelu(conv(to_nchw(x), P["convs.0.weight"], P["convs.0.bias"], 2, 1, quant=quant))
    for n in range(1, 4):
        h = conv(h, P[f"convs.{n}.weight"], P.get(f"convs.{n}.bias"), 2 if n < 3 else 1, 1,
                 quant=quant)
        if norm == "batch":
            name = f"norms.{n}"
            h = batch_norm(h, P[name + ".weight"], P[name + ".bias"], buffers, name,
                           update_stats)
        else:
            h = instance_norm(h)
        h = lrelu(h)
    return conv(h, P["out.weight"], P["out.bias"], 1, 1, quant=quant)
