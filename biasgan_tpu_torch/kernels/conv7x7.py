"""7x7 stride-1 VALID conv with one tiny channel side: the resnet
generator's stem (Cin <= 8) and head (Cout <= 8), on an input the caller
has already padded.

Counterpart of ``biasgan_tpu/ops/pallas_conv7.py::conv7x7_valid`` (:197),
both of its variants: ``smallcin`` (:142) for Cin <= 8 and ``smallcout``
(:169) for Cout <= 8; a shape with neither side tiny is refused, as there.
The kernels are CUDA C++ for sm_90a (csrc/conv7x7.cu, which says what
bounds them and how they are built up), compiled with nvcc on first use and
bound with ctypes.

``conv7x7`` takes its plain PyTorch version (``conv7x7_plain``) for a tensor
on the CPU and launches a kernel for a CUDA tensor; there is no fallback
from one to the other. The rule for a CUDA tensor: bf16 launches the
tensor-core kernel of its variant (the stem or the head, on ``wgmma``), f32
the CUDA-core checker. ``bf16_operands`` gives what the bf16 kernels take:
the weight packed per call into the kernel's slabs (``pack_stem_weight``
or ``pack_head_weight``: one gather by an index cached per shape, cheap
beside the conv, so the pack itself is not cached), the stem's Cout
rounded up to 8 for its TMA stores (the extra couts are sliced off y), the
head's C to 8 for its TMA loads, and the head's rows per unit for the
card's SMs (``head_rows``).
``conv7x7.launches`` counts the kernel calls, ``.wgmma_launches`` those on
the bf16 kernels.
Where autograd records, the call goes through a ``torch.autograd.Function``
with the VJP of ``conv7x7_op`` (pallas_conv7.py:337-375): the input grad is
the full conv of the cotangent with the flipped, transposed kernel, the
weight grad the batch-as-contraction conv (both ordinary conv grads, here
``aten.convolution_backward`` as XLA's convs there), dbias an f32 sum.
Both accumulate in f32 and add the f32 bias before the one cast to the
input's dtype (the plain generator path adds it after a bf16 conv, so the
two round differently).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from biasgan_tpu_torch.kernels.common import (
    INT,
    PTR,
    check_device,
    check_kernel_input,
    launch,
    ptr,
    sm_count,
    wants_grad,
)

# the bf16 kernels' geometry (csrc/conv7x7.cu): the stem's tile of output
# rows and columns; the head's unit columns, consumer warpgroups a block,
# and the shared memory its resident weight may take beside the row boxes
STEM_TH, STEM_TW = 8, 64
HEAD_TW, HEAD_NC = 64, 3
HEAD_WEIGHT_BYTES = 232448 - 1024 - HEAD_NC * 4 * 9216 - 2 * HEAD_NC * 4 * 8


def tiny_side(cin: int, cout: int) -> Optional[str]:
    """The variant for these channel counts ('smallcin' when Cin <= 8, else
    'smallcout' when Cout <= 8), or None when neither side is tiny."""
    if cin <= 8:
        return "smallcin"
    if cout <= 8:
        return "smallcout"
    return None


def _check_args(xp, weight, bias) -> None:
    if xp.ndim != 4:
        raise ValueError(f"xp must be NHWC, got shape {tuple(xp.shape)}")
    n, hp, wp, c = xp.shape
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 7, 7):
        raise ValueError(f"weight must be OIHW (Cout, {c}, 7, 7), got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
    if hp < 7 or wp < 7:
        raise ValueError(f"conv7x7 needs a padded input of at least 7x7, got {hp}x{wp}")
    if tiny_side(c, weight.shape[0]) is None:
        raise ValueError(f"conv7x7: neither side tiny (cin={c}, cout={weight.shape[0]})")


def conv7x7_plain(
    xp: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version of ``conv7x7``: the VALID conv of the
    storage-dtype values accumulated in f32, f32 bias, one cast. Set TF32
    off to compare it with the kernel on the card."""
    _check_args(xp, weight, bias)
    w = weight.to(xp.dtype).float()
    y = F.conv2d(xp.permute(0, 3, 1, 2).float(), w).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    return y.to(xp.dtype)


def stem_pixels(cin: int) -> int:
    """P, the pixels of one 16-byte unit the bf16 stem kernel stages, each
    at 8 / P channels: 2 for Cin <= 4 (14 k16 steps a row), else 1 (28)."""
    return 2 if cin <= 4 else 1


def _stem_layout(weight: torch.Tensor) -> torch.Tensor:
    """pack_stem_weight's layout of ``weight``, by copies (any dtype)."""
    cout, cin = weight.shape[:2]
    cp = 8 // stem_pixels(cin)
    n_cb = -(-cout // 64)
    w = F.pad(weight, (0, 1, 0, 0, 0, cp - cin, 0, 64 * n_cb - cout))  # (64 n_cb, cp, 7, 8)
    w = F.pad(w.permute(0, 2, 3, 1).reshape(64 * n_cb, 7, 8 * cp), (0, 64 - 8 * cp))
    return w.reshape(n_cb, 64, 7, 64).transpose(1, 2)


def pack_stem_weight(weight: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """OIHW ``weight`` (Cout, Cin <= 8, 7, 7) as the bf16 stem kernel's B:
    (n_cb, 7, 64, 64), n_cb = Cout / 64 rounded up: slab [cb, dy] is the
    K-major matrix of couts 64 cb .. 64 cb + 63 by k = dx cp + c (cp = 8 /
    P channels, ``stem_pixels``), which is where an output pixel's A row
    at dy finds input pixel + dx, channel c in the staged units; zero at dx
    7, past Cin, past Cout and past k = 8 cp; in ``dtype`` (the weight's by
    default). One gather (``_packed``)."""
    return _packed(_stem_layout, weight, dtype)


def head_couts_per_lane(cout: int) -> int:
    """CPL, the couts of one accumulator lane in the bf16 head kernel: 1
    for Cout <= 4 (U's N = 32 columns), else 2 (N = 56)."""
    return 1 if cout <= 4 else 2


def head_fits(cin: int, cout: int) -> bool:
    """Whether the bf16 head kernel's resident weight (7 slabs of N x 64
    channels per 64-channel block) fits its shared memory: C <= 256 at
    Cout <= 4, C <= 128 at Cout <= 8."""
    n = 32 if head_couts_per_lane(cout) == 1 else 56
    return -(-cin // 64) * 7 * n * 128 <= HEAD_WEIGHT_BYTES


def _head_layout(weight: torch.Tensor) -> torch.Tensor:
    """pack_head_weight's layout of ``weight``, by copies (any dtype)."""
    cout, cin = weight.shape[:2]
    n_kc = -(-cin // 64)
    if head_couts_per_lane(cout) == 1:
        w = F.pad(weight, (0, 0, 0, 1, 0, 64 * n_kc - cin, 0, 4 - cout))  # (4, C, 8 dy, 7)
        w = w.reshape(4, 64 * n_kc, 4, 2, 7).permute(4, 2, 0, 3, 1)  # (dx, dy // 2, co, dy % 2, C)
    else:
        w = F.pad(weight, (0, 0, 0, 0, 0, 64 * n_kc - cin, 0, 8 - cout))  # (8, C, 7, 7)
        w = w.permute(3, 2, 0, 1)  # (dx, dy, co, C)
    return w.reshape(7, -1, n_kc, 64).permute(2, 0, 1, 3).reshape(7 * n_kc, -1, 64)


def pack_head_weight(weight: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """OIHW ``weight`` (Cout <= 8, C, 7, 7) as the bf16 head kernel's B:
    (7 n_kc, N, 64), n_kc = C / 64 rounded up: slab 7 cb + dx is the
    K-major matrix of U's columns by channels 64 cb .. 64 cb + 63 at tap
    column dx, column n holding (dy, co) at n = 8 (dy // 2) + 2 co + dy % 2
    (CPL 1, N 32) or 8 dy + co (CPL 2, N 56); zero at dy 7, past C and past
    Cout; in ``dtype`` (the weight's by default). One gather (``_packed``)."""
    return _packed(_head_layout, weight, dtype)


@functools.lru_cache(maxsize=None)
def _pack_index(layout, shape: tuple, device: torch.device) -> torch.Tensor:
    """Where each element of ``layout``'s pack of a weight of ``shape``
    comes from: its flat index in the weight, or the weight's element
    count for a zero; on ``device``, built once per shape."""
    numel = 1
    for d in shape:
        numel *= d
    ids = layout(torch.arange(1, numel + 1, dtype=torch.float64).reshape(shape))
    idx = ids.long() - 1
    return torch.where(idx < 0, numel, idx).contiguous().to(device)


def _packed(layout, weight, dtype):
    """``layout``'s pack of ``weight`` in ``dtype`` (the weight's by
    default) by one gather from the flat weight and one zero: the layout's
    pads, permutes and copies ran once on indices (``_pack_index``)."""
    flat = F.pad(weight.reshape(-1).to(dtype or weight.dtype), (0, 1))
    return flat[_pack_index(layout, tuple(weight.shape), weight.device)]


@functools.lru_cache(maxsize=None)
def head_rows(n: int, h: int, w: int, sms: int) -> int:
    """The output rows of one unit of the bf16 head kernel for output
    (n, h, w) on a card of ``sms`` SMs: the largest of those that least
    load the busiest consumer warpgroup, which walks rounds x (rows + 6)
    staged rows (rounds: the units, n x segments x 64-column strips, over
    the grid's sms x HEAD_NC warpgroups)."""
    strips, slots = -(-w // HEAD_TW), sms * HEAD_NC

    def load(th):
        return -(-n * -(-h // th) * strips // slots) * (th + 6)

    return min(range(h, 0, -1), key=load)


def bf16_operands(xp, weight, bias, sms):
    """What the bf16 kernel takes for one call on a card of ``sms`` SMs:
    ``(x, packed weight, bias, cout_k, pack, rows)``. The stem: the weight
    packed by ``pack_stem_weight``, the f32 bias zero-padded to the packed
    couts (the kernel reads 64 a launch), cout_k Cout rounded up to 8 (y's
    TMA stores; the caller slices), pack P (``stem_pixels``), rows 0. The head: x's channels zero-padded to
    a multiple of 8 (its TMA loads), the weight packed by
    ``pack_head_weight``, the f32 bias, cout_k Cout, pack CPL
    (``head_couts_per_lane``), rows ``head_rows``; raises where the weight
    does not fit (``head_fits``)."""
    n, hp, wp, c = xp.shape
    cout = weight.shape[0]
    if tiny_side(c, cout) == "smallcin":
        packed = pack_stem_weight(weight, xp.dtype)
        if bias is not None:
            bias = bias.float().contiguous()
            if 64 * packed.shape[0] != cout:
                bias = F.pad(bias, (0, 64 * packed.shape[0] - cout))
        return xp, packed, bias, cout + -cout % 8, stem_pixels(c), 0
    if not head_fits(c, cout):
        raise ValueError(f"conv7x7 bf16 head kernel: C {c} too large for Cout {cout} "
                         "(C <= 256 at Cout <= 4, C <= 128 at Cout <= 8)")
    if c % 8:
        xp = F.pad(xp, (0, -c % 8))
    packed = pack_head_weight(weight, xp.dtype)
    bias = None if bias is None else bias.float().contiguous()
    return (xp, packed, bias, cout, head_couts_per_lane(cout),
            head_rows(n, hp - 6, wp - 6, sms))


_ARGTYPES = [PTR] * 4 + [INT] * 10


def _launch(xp, weight, bias):
    n, hp, wp, c = xp.shape
    cout = weight.shape[0]
    dtype = check_kernel_input("conv7x7", xp, n * (hp - 6) * (wp - 6) * cout)
    dev = xp.device
    smallcin = tiny_side(c, cout) == "smallcin"
    wgmma = xp.dtype == torch.bfloat16
    if wgmma:
        blocks = sm_count(dev)
        xp, wk, b, cout_k, pack, rows = bf16_operands(xp, weight, bias, blocks)
        if not smallcin and xp.data_ptr() % 16:
            raise ValueError("conv7x7 bf16 head kernel needs a 16-byte aligned x (TMA loads)")
    else:
        # (49, Cin, Cout): tap dy * 7 + dx of the OIHW weight
        wk = weight.to(xp.dtype).permute(2, 3, 1, 0).reshape(49, c, cout).contiguous()
        b = None if bias is None else bias.float().contiguous()
        cout_k, pack, rows, blocks = cout, 0, 0, 0
    y = torch.empty((n, hp - 6, wp - 6, cout_k), dtype=xp.dtype, device=dev)
    launch(
        "conv7x7", "conv7x7_launch", _ARGTYPES, dev,
        ptr(xp), ptr(wk), ptr(b), ptr(y),
        n, hp, wp, xp.shape[3], cout_k, dtype, int(smallcin), pack, rows, blocks,
    )
    conv7x7.launches += 1
    conv7x7.wgmma_launches += wgmma
    return y[..., :cout].contiguous() if cout_k != cout else y


def conv7x7(
    xp: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """VALID 7x7 stride-1 conv (torch cross-correlation) of the padded NHWC
    ``xp`` (N, H+6, W+6, Cin), f32 or bf16, with the OIHW ``weight``
    (Cout, Cin, 7, 7) cast to xp's dtype and an optional f32 bias, where
    Cin <= 8 or Cout <= 8. Returns (N, H, W, Cout) in xp's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    (bf16: the tensor-core kernel, counted also in ``.wgmma_launches``;
    f32: the CUDA-core one; both in ``conv7x7.launches``) or raises. Where
    autograd records, the call is differentiable (``_Conv7x7Op``)."""
    _check_args(xp, weight, bias)
    if wants_grad(xp, weight, bias):
        return _Conv7x7Op.apply(xp, weight, bias)
    return _conv7x7(xp, weight, bias)


def _conv7x7(xp, weight, bias):
    if check_device("conv7x7", xp, [weight, bias]):
        return conv7x7_plain(xp, weight, bias)
    return _launch(xp, weight, bias)


conv7x7.launches = 0
conv7x7.wgmma_launches = 0


class _Conv7x7Op(torch.autograd.Function):
    """The kernel's forward with the VJP of pallas_conv7.py::_c7_bwd."""

    @staticmethod
    def forward(ctx, xp, weight, bias):
        ctx.save_for_backward(xp, weight, bias)
        return _conv7x7(xp, weight, bias)

    @staticmethod
    def backward(ctx, g):
        xp, weight, bias = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        dxp, dw, _ = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2), weight.to(xp.dtype), None,
            [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask,
        )
        if dxp is not None:
            dxp = dxp.permute(0, 2, 3, 1).to(xp.dtype)
        if dw is not None:
            dw = dw.to(weight.dtype)
        db = None
        if bias is not None and ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2)).to(bias.dtype)
        return dxp, dw, db
