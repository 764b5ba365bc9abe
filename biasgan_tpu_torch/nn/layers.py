"""Core spatial layers with torch semantics, NHWC activations.

Counterpart of ``biasgan_tpu/nn/layers.py``. Activations are NHWC at every
public function (the JAX layout, so tests compare like with like); weights
are in the torch layout (conv OIHW, conv-transpose IOHW), so reference
``.pth`` files load as they are. Convolutions run through cuDNN on the
channels_last view of the NHWC tensor (``permute(0, 3, 1, 2)`` is a free
view), so no layout copy is made.

What follows the JAX package exactly, because it moves the numbers:

* padding is explicit and per axis (H and W each zero / reflect / wrap),
  with ``jnp.pad`` semantics for any pad width;
* ``compute_dtype`` casts the input and the weight per conv (the module
  params stay f32), and the bias is added in the conv's output dtype;
* the periodic-W conv-transpose dilates W by hand and pads it circularly
  (``F.conv_transpose2d`` cannot wrap);
* instance-norm statistics are f32 with var = max(E[x^2] - E[x]^2, 0).

Under a spatial context ``ctx`` (``parallel.spatial.HaloCtx``: W sharded
over ranks) the W pads come by halo exchange, the instance-norm statistics
are global over W, the periodic conv-transpose dilates its local shard, and
the kernel routes below stay off, as the JAX gates turn them off under a
context (layers.py:399, 421, 781).

The TPU rewrites of the JAX layers (cin padding, space-to-depth, the
tiny-cin VJP, the phase-decomposed and one-buffer conv-transposes) are not
carried: they reorganize the same arithmetic for the TPU's matrix unit.
The JAX layers' opt-in kernel routes are, as arguments where the JAX
package reads its perf gates: ``conv7`` in ``conv2d`` (the 7x7 kernel),
``pallas_conv`` in ``conv2d`` (the VALID 3x3 kernel and its VJP), ``fused``
in ``norm_act`` (the fused instance-norm kernel), the fused block conv as
``Conv2d.forward_fused`` (differentiable where autograd records), and the
fused stride-2 down and up convs as ``Conv2d.forward_fused_s2`` and
``ConvTranspose2d.forward_fused`` (inference only, as in JAX).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused
from biasgan_tpu_torch.kernels.conv3x3_valid import conv3x3_valid
from biasgan_tpu_torch.kernels.conv3x3s2_fused import conv3x3s2_fused
from biasgan_tpu_torch.kernels.conv7x7 import conv7x7
from biasgan_tpu_torch.kernels.convt3x3s2_fused import convt3x3s2_fused
from biasgan_tpu_torch.kernels.instance_norm_act import instance_norm_act
from biasgan_tpu_torch.ops.padding import pad_axis, pad_hw


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> its NCHW view (channels_last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _in_compute_dtype(x, weight, compute_dtype):
    """(x, weight) cast to ``compute_dtype`` (None keeps them as they are),
    as every conv casts per call."""
    if compute_dtype is None:
        return x, weight
    return x.to(compute_dtype), weight.to(compute_dtype)


# ---------------------------------------------------------------------------
# Weight init (reference semantics: init_weights in models/networks.py)
# ---------------------------------------------------------------------------

InitFn = Callable[[Tuple[int, ...], Optional[torch.Generator]], torch.Tensor]


def _randn(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32)


def make_conv_init(init_type: str = "normal", init_gain: float = 0.02) -> InitFn:
    """Conv-kernel initializer matching the reference's ``init_weights``:
    normal(0, gain) / xavier(gain) / kaiming / orthogonal(gain).

    Returns ``init(shape, generator)`` drawing an f32 kernel in the JAX
    package's HWIO shape (kh, kw, cin, cout), so fan-in and fan-out are
    counted as there; the modules transpose it to their torch layout."""
    if init_type == "normal":
        return lambda shape, g: _randn(shape, g) * init_gain
    if init_type == "xavier":
        # torch xavier_normal_(gain=g): std = g * sqrt(2 / (fan_in + fan_out))
        def xavier(shape, g):
            rf = math.prod(shape[:-2])
            std = init_gain * math.sqrt(2.0 / (rf * shape[-2] + rf * shape[-1]))
            return _randn(shape, g) * std

        return xavier
    if init_type == "kaiming":
        # kaiming_normal_(a=0, mode='fan_in'): std = sqrt(2 / fan_in)
        return lambda shape, g: _randn(shape, g) * math.sqrt(
            2.0 / math.prod(shape[:-1])
        )
    if init_type == "orthogonal":
        def orthogonal(shape, g):
            # the (prod(shape[:-1]), cout) matrix has orthonormal columns
            # (rows, if it is wide), scaled by gain
            rows, cols = math.prod(shape[:-1]), shape[-1]
            a = _randn((max(rows, cols), min(rows, cols)), g)
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r))
            if rows < cols:
                q = q.T
            return (init_gain * q).reshape(shape)

        return orthogonal
    raise ValueError(f"unknown init_type {init_type!r}")


def batchnorm_scale_init(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Reference inits BatchNorm weight ~ N(1.0, 0.02), bias = 0."""
    return 1.0 + 0.02 * _randn(shape, generator)


# ---------------------------------------------------------------------------
# Functional ops
# ---------------------------------------------------------------------------


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    h_mode: str = "zero",
    w_mode: str = "zero",
    compute_dtype: Optional[torch.dtype] = None,
    conv7: bool = False,
    pallas_conv: bool = False,
    ctx=None,
) -> torch.Tensor:
    """torch ``Conv2d(k, stride, padding)`` on NHWC ``x`` with per-axis pad
    modes. ``weight`` is OIHW. Under a spatial context ``ctx`` x is this
    rank's W shard and W is padded by halo exchange; the two kernel routes
    below are then off.

    ``pallas_conv`` routes a 3x3 stride-1 pad-1 conv through the
    ``conv3x3_valid`` kernel on the padded input (through ``conv3x3_op``,
    whose input gradient runs the same kernel, where autograd records), the
    bias added after, in the conv's dtype (the JAX ``--pallas_conv`` route,
    biasgan_tpu/nn/layers.py:389-407; its ``cin, cout >= 128`` and ``W % 8``
    conditions are TPU regime splits and are not carried).

    ``conv7`` routes a 7x7 stride-1 pad-3 conv with exactly one channel
    side of at most 8 (the resnet stem and head) through the ``conv7x7``
    kernel on the padded input, with f32 accumulation and the bias added
    before the one cast (the JAX ``--conv7_pallas`` route,
    biasgan_tpu/nn/layers.py:408-426)."""
    ph, pw = padding
    kh, kw = weight.shape[2:]
    out_h = (x.shape[1] + 2 * ph - kh) // stride[0] + 1
    out_w = (x.shape[2] + 2 * pw - kw) // stride[1] + 1
    if out_h <= 0 or out_w <= 0:
        raise ValueError(
            f"conv2d produces empty output {out_h}x{out_w} from input "
            f"{tuple(x.shape)} with k=({kh},{kw}) s={stride} p={padding} — "
            "input too small for this network"
        )
    x = pad_hw(x, (ph, ph), (pw, pw), h_mode, w_mode, ctx)
    x, weight = _in_compute_dtype(x, weight, compute_dtype)
    pallas_conv = pallas_conv and ctx is None
    if pallas_conv and (kh, kw) == (3, 3) and tuple(stride) == (1, 1) and (ph, pw) == (1, 1):
        y = conv3x3_valid(x, weight)
    elif conv7 and ctx is None and conv7_eligible(weight.shape, stride, padding):
        return conv7x7(x, weight, bias)
    else:
        y = _nhwc(F.conv2d(_nchw(x), weight, None, stride))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv7_eligible(weight_shape, stride, padding) -> bool:
    """Whether ``conv2d(..., conv7=True)`` takes the 7x7 kernel: a 7x7
    stride-1 pad-3 conv with exactly one channel side of at most 8 (the
    JAX gate, biasgan_tpu/nn/layers.py:414-419; its GEMM-size and cin-pad
    conditions are TPU regime splits and are not carried)."""
    cout, cin, kh, kw = weight_shape
    return (
        (kh, kw) == (7, 7)
        and tuple(stride) == (1, 1)
        and tuple(padding) == (3, 3)
        and (cin <= 8) != (cout <= 8)
    )


def conv_transpose2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    output_padding: Tuple[int, int] = (0, 0),
    compute_dtype: Optional[torch.dtype] = None,
    w_mode: str = "zero",
    ctx=None,
) -> torch.Tensor:
    """torch ``ConvTranspose2d(k, stride, padding, output_padding)`` on NHWC
    ``x``; ``weight`` is IOHW. out = (in - 1) * s - 2p + k + op per axis.

    ``w_mode='wrap'`` makes the W axis periodic (longitude): W is dilated by
    hand to ``W * s`` and padded circularly, then a VALID conv with the
    spatially flipped, I/O-swapped kernel runs over it (H keeps the zero
    padded dilation), so the upsampled field is seamless across the
    dateline. This requires output width == W * s, i.e. 2p == k - s + op,
    true for every conv-transpose in the zoo.

    Under a spatial context ``ctx`` (x is this rank's W shard) the same
    holds with the local dilation to ``W_local * s`` padded by halo
    exchange (wrap or zero by the context's edge rule), so the shards'
    concatenation is the global dilation (JAX layers.py:650-656); H is then
    the transposed conv as it stands, W a VALID correlation."""
    kh, kw = weight.shape[2:]
    (sh, sw), (ph, pw), (oph, opw) = stride, padding, output_padding
    x, weight = _in_compute_dtype(x, weight, compute_dtype)
    if ctx is None and w_mode != "wrap":
        y = _nhwc(
            F.conv_transpose2d(_nchw(x), weight, None, stride, padding, output_padding)
        )
    else:
        if 2 * pw != kw - sw + opw:
            raise ValueError(
                "periodic conv-transpose requires out_width == in_width * "
                f"stride (2p == k - s + op); got k={kw} s={sw} p={pw} op={opw}"
            )
        n, h, w, c = x.shape
        if ctx is not None:
            xw = x.new_zeros((n, h, w * sw, c))
            xw[:, :, ::sw] = x
            xw = ctx.pad_w(xw, kw - 1 - pw, pw)
            y = _nhwc(F.conv_transpose2d(
                _nchw(xw), weight, None, (sh, 1), (ph, kw - 1), (oph, 0)
            ))
            if bias is not None:
                y = y + bias.to(y.dtype)
            return y
        top = kh - 1 - ph
        # rows: the stride dilation with its zero pad (top, top + op);
        # columns: W * s with the values at multiples of s (the trailing
        # zeros complete the period), then the circular pad
        xd = x.new_zeros((n, top + (h - 1) * sh + 1 + top + oph, w * sw, c))
        xd[:, top : top + (h - 1) * sh + 1 : sh, ::sw] = x
        xd = pad_axis(xd, 2, kw - 1 - pw, pw, "wrap")
        wconv = weight.transpose(0, 1).flip(2, 3)  # IOHW -> flipped OIHW
        y = _nhwc(F.conv2d(_nchw(xd), wconv))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5, ctx=None) -> torch.Tensor:
    """torch ``InstanceNorm2d(affine=False, track_running_stats=False)`` on
    NHWC ``x``, with the JAX package's arithmetic: f32 statistics, biased
    variance max(E[x^2] - E[x]^2, 0), output in x's dtype. Under a spatial
    context ``ctx`` the statistics are global over the sharded W."""
    xf = x.float()
    if ctx is None:
        mean = xf.mean(dim=(1, 2), keepdim=True)
        mean2 = xf.square().mean(dim=(1, 2), keepdim=True)
    else:
        mean, mean2 = ctx.mean_w(xf, xf.square(), dims=(1, 2))
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "none":
        return x
    if activation == "relu":
        return F.relu(x)
    if activation == "lrelu":
        return F.leaky_relu(x, negative_slope=0.2)
    raise ValueError(f"unknown activation {activation!r}")


def norm_act(
    x: torch.Tensor,
    norm: nn.Module,
    activation: str = "none",
    residual: Optional[torch.Tensor] = None,
    fused: bool = False,
    ctx=None,
) -> torch.Tensor:
    """norm -> [+ residual] -> activation, the chain that follows every conv.

    ``fused`` sends an instance norm through the ``instance_norm_act``
    kernel (the JAX ``--force_pallas_norm`` route,
    biasgan_tpu/nn/layers.py:781-784): the residual is then added in f32
    and the result cast once, where this plain chain casts the norm to x's
    dtype before the add. Under a spatial context ``ctx`` the instance
    norm's statistics are global over W and ``fused`` is off."""
    if isinstance(norm, InstanceNorm):
        if fused and ctx is None:
            return instance_norm_act(x, residual, activation, norm.eps)
        h = instance_norm(x, norm.eps, ctx)
    elif isinstance(norm, BatchNorm):
        h = norm(x, ctx)
    else:
        h = norm(x)
    if residual is not None:
        h = h + residual
    return apply_activation(h, activation)


def norm_uses_bias(norm_type: str) -> bool:
    """Reference: conv bias is used iff the following norm is not batch norm
    (batch norm's own bias makes it redundant)."""
    return norm_type != "batch"


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class InstanceNorm(nn.Module):
    """Affine-free instance norm (reference get_norm_layer semantics)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.eps)


class BatchNorm(nn.Module):
    """Batch norm on NHWC with the buffers and names of torch
    ``BatchNorm2d`` (weight, bias, running_mean, running_var,
    num_batches_tracked), with the arithmetic of the JAX package's flax
    ``BatchNorm`` (biasgan_tpu/nn/layers.py:699-740, flax 0.12.3): f32
    statistics, output in ``dtype`` (None = f32).

    In training the statistics are the batch's over (N, H, W): the mean and
    the biased variance max(E[x^2] - E[x]^2, 0) (flax's
    ``use_fast_variance``), with gradients through both; each forward moves
    the running averages as flax does, ``r = 0.9 r + 0.1 batch`` with the
    biased variance (torch's own running update would take the unbiased
    one), unless ``update_stats`` is off (``running_stats_frozen``). In eval
    the running averages normalize. Either way
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, flax's order."""

    def __init__(
        self,
        num_features: int,
        eps: float = 1e-5,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.eps = eps
        self.out_dtype = dtype
        self.update_stats = True
        self.weight = nn.Parameter(batchnorm_scale_init((num_features,), generator))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        xf = x.float()
        if self.training:
            if ctx is not None:
                raise NotImplementedError(
                    "batch-norm training on a sharded W (W-global batch moments) is not "
                    "ported yet: it comes with the sharded pix2pix step"
                )
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp(xf.square().mean(dim=(0, 1, 2)) - mean.square(), min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    # flax: ra = momentum * ra + (1 - momentum) * batch
                    self.running_mean.copy_(0.9 * self.running_mean + (1 - 0.9) * mean)
                    self.running_var.copy_(0.9 * self.running_var + (1 - 0.9) * var)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(self.out_dtype or torch.float32)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Within the block, ``module``'s batch norms normalize as they would
    (batch statistics in training) but leave their running averages as they
    are: the JAX pix2pix step throws away the stats its gradient penalty's
    D forward updates (biasgan_tpu/models/pix2pix.py:220-225)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def make_norm(
    norm_type: str,
    num_features: int,
    dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """'batch' | 'instance' | 'none' (counterpart of the JAX ``Norm``)."""
    if norm_type == "batch":
        return BatchNorm(num_features, dtype=dtype, generator=generator)
    if norm_type == "instance":
        return InstanceNorm()
    if norm_type == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {norm_type!r}")


class Conv2d(nn.Module):
    """torch-semantics Conv2d on NHWC activations, OIHW weight, with
    explicit per-axis padding modes."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Tuple[int, int],
        stride: Tuple[int, int] = (1, 1),
        padding: Tuple[int, int] = (0, 0),
        use_bias: bool = True,
        h_mode: str = "zero",
        w_mode: str = "zero",
        init_type: str = "normal",
        init_gain: float = 0.02,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kh, kw = kernel_size
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.h_mode = h_mode
        self.w_mode = w_mode
        self.compute_dtype = compute_dtype
        hwio = make_conv_init(init_type, init_gain)(
            (kh, kw, in_channels, out_channels), generator
        )
        self.weight = nn.Parameter(hwio.permute(3, 2, 0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(
        self, x: torch.Tensor, conv7: bool = False, pallas_conv: bool = False, ctx=None
    ) -> torch.Tensor:
        return conv2d(
            x,
            self.weight,
            self.bias,
            self.stride,
            self.padding,
            self.h_mode,
            self.w_mode,
            self.compute_dtype,
            conv7,
            pallas_conv,
            ctx,
        )

    def forward_fused(
        self,
        x: torch.Tensor,
        prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        halo: bool = False,
    ):
        """This 3x3 s1 p1 conv through ``kernels.conv3x3_fused``: SAME pad
        in the kernel, optional instance-norm + ReLU prologue ``(a, b)`` on
        the input, and the (sum, sumsq) moments of the output. Returns
        ``(y, (sum, sumsq))``. Where autograd records (training), the call
        takes ``conv3x3_fused_t``, the same kernel with its exact backward
        (the JAX ``fused_diff`` branch, biasgan_tpu/nn/layers.py:866-879).
        ``halo``: x carries its halo-exchanged W pad columns (the kernel's
        ``w_mode='halo'``, the spatially sharded path)."""
        if tuple(self.weight.shape[2:]) != (3, 3) or self.stride != (1, 1) or (
            self.padding != (1, 1)
        ):
            raise ValueError("forward_fused needs a 3x3 stride-1 pad-1 conv")
        x, w = _in_compute_dtype(x, self.weight, self.compute_dtype)
        return conv3x3_fused(
            x, w, self.bias, prologue=prologue, act_pre="relu",
            h_mode=self.h_mode, w_mode="halo" if halo else self.w_mode,
            want_moments=True,
        )

    def forward_fused_s2(
        self,
        x: torch.Tensor,
        prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """This 3x3 stride-2 pad-1 conv (H zero pad) through
        ``kernels.conv3x3s2_fused``: optional instance-norm + ReLU prologue
        ``(a, b)`` on the input, and the (sum, sumsq) moments of the output
        (the JAX ``fused_s2_plan`` branch, biasgan_tpu/nn/layers.py:845-864).
        Returns ``(y, (sum, sumsq))``."""
        if tuple(self.weight.shape[2:]) != (3, 3) or self.stride != (2, 2) or (
            self.padding != (1, 1)
        ) or self.h_mode != "zero":
            raise ValueError("forward_fused_s2 needs a 3x3 stride-2 pad-1 conv, H zero")
        x, w = _in_compute_dtype(x, self.weight, self.compute_dtype)
        return conv3x3s2_fused(
            x, w, self.bias, prologue=prologue, act_pre="relu",
            w_mode=self.w_mode, want_moments=True,
        )


class ConvTranspose2d(nn.Module):
    """torch-semantics ConvTranspose2d on NHWC activations, IOHW weight.
    ``w_mode='wrap'`` makes the width axis periodic (longitude)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Tuple[int, int],
        stride: Tuple[int, int] = (2, 2),
        padding: Tuple[int, int] = (1, 1),
        output_padding: Tuple[int, int] = (0, 0),
        use_bias: bool = True,
        w_mode: str = "zero",
        init_type: str = "normal",
        init_gain: float = 0.02,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kh, kw = kernel_size
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.output_padding = tuple(output_padding)
        self.w_mode = w_mode
        self.compute_dtype = compute_dtype
        hwio = make_conv_init(init_type, init_gain)(
            (kh, kw, in_channels, out_channels), generator
        )
        self.weight = nn.Parameter(hwio.permute(2, 3, 0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        return conv_transpose2d(
            x,
            self.weight,
            self.bias,
            self.stride,
            self.padding,
            self.output_padding,
            self.compute_dtype,
            self.w_mode,
            ctx,
        )

    def forward_fused(
        self,
        x: torch.Tensor,
        prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """This 3x3 stride-2 pad-1 output-pad-1 conv-transpose through
        ``kernels.convt3x3s2_fused``: optional instance-norm + ReLU prologue
        ``(a, b)`` on the input, and the (sum, sumsq) moments of the whole
        (N, 2H, 2W, Cout) output (the JAX ``fused_plan`` branch,
        biasgan_tpu/nn/layers.py:942-968). Returns ``(y, (sum, sumsq))``."""
        if tuple(self.weight.shape[2:]) != (3, 3) or self.stride != (2, 2) or (
            self.padding != (1, 1) or self.output_padding != (1, 1)
        ):
            raise ValueError("forward_fused needs a 3x3 stride-2 pad-1 output-pad-1 convT")
        x, w = _in_compute_dtype(x, self.weight, self.compute_dtype)
        return convt3x3s2_fused(
            x, w, self.bias, prologue=prologue, act_pre="relu",
            w_mode="wrap" if self.w_mode == "wrap" else "zero", want_moments=True,
        )
