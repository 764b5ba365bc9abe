"""Fused stride-2 down conv: torch ``Conv2d(3, stride 2, padding 1)`` on an
NHWC input of even H and W, the H axis zero padded and W wrap or zero
padded, with an optional instance-norm + activation prologue on the input
and the per-(N, Cout) moments of the output.

Counterpart of ``biasgan_tpu/ops/pallas_conv.py::conv3x3s2_fused`` (:1663).
The kernels are CUDA C++ for sm_90a (csrc/conv3x3s2_fused.cu, which says
what bounds them and how they are built up), compiled with nvcc on first
use and bound with ctypes.

``conv3x3s2_fused`` takes its plain PyTorch version
(``conv3x3s2_fused_plain``) for a tensor on the CPU and launches a kernel
for a CUDA tensor; there is no fallback from one to the other. The rule
for a CUDA tensor: bf16 launches the TMA / wgmma kernel, f32 the
CUDA-core checker. The bf16 kernel reads x through its phase view and
stores y with TMA, which needs C and Cout multiples of 8 and a 16-byte
aligned x: the wrapper zero-pads C up to a multiple of 8 (zero weights,
zero prologue a and b: act(0) = 0 adds nothing) and Cout likewise (zero
weights and bias, the extra couts sliced off y and the moments), and
raises for a misaligned x. ``conv3x3s2_fused.launches``
counts every kernel launch, ``conv3x3s2_fused.wgmma_launches`` those of
the bf16 kernel.

``pack_phase_weight`` lays the OIHW weight out as the bf16 kernel's B
operand: the merged tap matrices of the phase view, k-block by k-block
(``phase_k_blocks``).

As in the Pallas kernel, the moments are those of the stored, down-cast
output. Differences from the Pallas wrapper: no plan argument (the tiling
is the kernel's own), the weight is OIHW, and the prologue is
``conv3x3_fused``'s (f32 a and b, f32 math, one cast to x's dtype), where
the Pallas wrapper casts a and b to x's dtype and computes in it: in bf16
that rounding moves the served generator past the repository's bf16 rule
(csrc/conv3x3s2_fused.cu).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from biasgan_tpu_torch.kernels.common import (
    ACT_CODE,
    PAD_CODE,
    INT,
    PTR,
    affine_act,
    check_device,
    check_kernel_input,
    launch,
    num_tiles,
    pad_channels,
    pad_couts,
    ptr,
    refuse_grad,
    sm_count,
    stored_moments,
)
from biasgan_tpu_torch.ops.padding import pad_hw

W_MODES = ("wrap", "zero")
KW = 64  # merged channels per k-block of the bf16 kernel (one 128-byte row)


def tile_geometry(cout: int) -> Tuple[int, int, int]:
    """(BN couts, BW pair columns, BH pair rows) of the bf16 kernel's tile,
    as csrc/conv3x3s2_fused.cu's Geom sets them: 128 pixels of one pair row
    by 128 couts for Cout <= 128, by 256 above (the packed weight's couts
    are padded to BN)."""
    return (128 if cout <= 128 else 256), 128, 1


def phase_k_blocks(c: int) -> List[Tuple[int, int, int]]:
    """The bf16 kernel's k-blocks for C input channels (C % 8 == 0), in
    order: (row tap dy, pair-column offset, channel block). In the phase
    view (N, H/2, 2, W/2, 2C) output pixel (a, b) reads, for row tap dy,
    plane 0 at pair row a (dy 1) or plane 1 at pair row a - 1 (dy 0) or a
    (dy 2); at offset 0 every 64-channel block of pair column b (merged
    channels c' < C: tap dx 1, c' >= C: dx 2), at offset -1 the blocks of
    pair column b - 1 that hold its odd half (dx 0)."""
    nb2, nb_lo = -(-2 * c // KW), c // KW
    per_tap = [(0, cb) for cb in range(nb2)] + [(-1, cb) for cb in range(nb_lo, nb2)]
    return [(dy, off, cb) for dy in range(3) for off, cb in per_tap]


def pack_phase_weight(weight: torch.Tensor, bn: int) -> torch.Tensor:
    """OIHW ``weight`` (Cout, C, 3, 3), C % 8 == 0, as the bf16 kernel's B:
    (k-blocks, Cout rounded up to ``bn``, 64), slab kb the K-major merged
    tap matrix of ``phase_k_blocks(C)[kb]``: [W[dy, 1]; W[dy, 2]] over the
    2C merged channels at offset 0, [0; W[dy, 0]] at offset -1, zero past
    2C and past Cout. Pure data movement, so it gathers as well as it
    copies: ``_phase_index`` runs it on indices."""
    cout, c = weight.shape[:2]
    nb2, nb_lo = -(-2 * c // KW), c // KW
    wt = weight.permute(2, 3, 0, 1)  # (dy, dx, Cout, C)
    m = torch.cat([wt[:, 1], wt[:, 2]], dim=2)  # (3, Cout, 2C)
    n = torch.cat([torch.zeros_like(wt[:, 0]), wt[:, 0]], dim=2)
    k = F.pad(torch.stack([m, n], 1), (0, nb2 * KW - 2 * c))
    k = k.reshape(3, 2, cout, nb2, KW)
    blocks = torch.cat([k[:, 0], k[:, 1, :, nb_lo:]], dim=2)  # (3, Cout, kbw, 64)
    blocks = F.pad(blocks.permute(0, 2, 1, 3), (0, 0, 0, -(-cout // bn) * bn - cout))
    return blocks.reshape(-1, blocks.shape[2], KW).contiguous()


@functools.lru_cache(maxsize=32)
def _phase_index(cout: int, c: int, bn: int, device: torch.device) -> torch.Tensor:
    """pack_phase_weight as a gather: index 1 + i of the flat OIHW weight,
    0 where the packed slab holds a zero."""
    idx = torch.arange(1, cout * c * 9 + 1, dtype=torch.int64).reshape(cout, c, 3, 3)
    return pack_phase_weight(idx, bn).to(device)


def _packed_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """pack_phase_weight(weight) in ``dtype`` on weight's device, as one
    gather from the flat weight with a zero in front."""
    cout, c = weight.shape[:2]
    flat = F.pad(weight.to(dtype).reshape(-1), (1, 0))
    return flat[_phase_index(cout, c, tile_geometry(cout)[0], weight.device)]


def _check_args(x, weight, bias, prologue, act_pre, w_mode) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"conv3x3s2_fused needs even H and W, got {h}x{w}")
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(f"weight must be OIHW (Cout, {c}, 3, 3), got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
    for t in prologue or ():
        if tuple(t.shape) != (n, c):
            raise ValueError(f"prologue tensors must be ({n}, {c}), got {tuple(t.shape)}")
    if act_pre not in ACT_CODE:
        raise ValueError(f"unknown act_pre {act_pre!r}")
    if w_mode not in W_MODES:
        raise ValueError(f"unknown w_mode {w_mode!r}; expected one of {W_MODES}")


def conv3x3s2_fused_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """Plain PyTorch version of ``conv3x3s2_fused``: the prologue, the
    pad, the stride-2 conv of the storage-dtype values
    accumulated in f32, f32 bias, one cast, sums of the stored value. Set
    TF32 off to compare it with the kernel on the card."""
    _check_args(x, weight, bias, prologue, act_pre, w_mode)
    if prologue is not None:
        x = affine_act(x, *prologue, act_pre)
    xp = pad_hw(x, (1, 1), (1, 1), "zero", w_mode)
    w = weight.to(x.dtype).float()
    y = F.conv2d(xp.permute(0, 3, 1, 2).float(), w, stride=2).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    return (y, stored_moments(y)) if want_moments else y


_ARGTYPES = [PTR] * 8 + [INT] * 9


def _launch(x, weight, bias, prologue, act_pre, w_mode, want_moments):
    n, h, w, _ = x.shape
    cout = weight.shape[0]
    dtype = check_kernel_input("conv3x3s2_fused", x, n * h * w * cout // 4)
    dev = x.device
    wgmma = x.dtype == torch.bfloat16
    cout_k = cout  # the kernel's Cout: a multiple of 8 for the bf16 kernel's TMA stores
    if wgmma:
        if x.data_ptr() % 16:
            raise ValueError("conv3x3s2_fused bf16 kernel needs a 16-byte aligned x "
                             "(TMA loads)")
        x, weight, prologue = pad_channels(x, weight, prologue)
        weight, bias = pad_couts(weight, bias)
        cout_k = weight.shape[0]
        wk = _packed_weight(weight, x.dtype)
    else:
        wk = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(9, x.shape[3], cout).contiguous()
    b = None if bias is None else bias.float().contiguous()
    pa = pb = None
    if prologue is not None:
        pa, pb = (t.float().contiguous() for t in prologue)
        if wgmma and (pa.data_ptr() % 16 or pb.data_ptr() % 16):
            pa, pb = pa.clone(), pb.clone()  # the kernel loads them in pairs
    y = torch.empty((n, h // 2, w // 2, cout_k), dtype=x.dtype, device=dev)
    # bf16: a grid block per SM, each adding into a zeroed moment slot of
    # its own; f32: a slot per pixel tile
    n_parts = (sm_count(dev) if wgmma
               else num_tiles("conv3x3s2_fused", "conv3x3s2_fused_num_tiles", h, w))
    part = moments = None
    if want_moments:
        part = (torch.zeros if wgmma else torch.empty)(
            (2, n, n_parts, cout_k), dtype=torch.float32, device=dev)
        moments = torch.empty((2, n, cout_k), dtype=torch.float32, device=dev)
    launch(
        "conv3x3s2_fused", "conv3x3s2_fused_launch", _ARGTYPES, dev,
        ptr(x), ptr(wk), ptr(b), ptr(pa), ptr(pb), ptr(y), ptr(part), ptr(moments),
        n, h, w, x.shape[3], cout_k, n_parts, dtype, PAD_CODE[w_mode], ACT_CODE[act_pre],
    )
    conv3x3s2_fused.launches += 1
    conv3x3s2_fused.wgmma_launches += wgmma
    if cout_k != cout:
        y = y[..., :cout].contiguous()
    if not want_moments:
        return y
    return y, (moments[0, :, :cout], moments[1, :, :cout])


def conv3x3s2_fused(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """torch ``Conv2d(3, stride 2, padding 1)`` of NHWC ``x`` (N, H, W, C),
    H and W even, f32 or bf16, with the OIHW ``weight`` (Cout, C, 3, 3) cast
    to x's dtype and an optional f32 bias. H is zero padded; ``w_mode`` is
    'wrap' (periodic longitude) or 'zero'. ``prologue=(a, b)`` ((N, C) f32)
    makes the input ``act_pre(a*x + b)``, cast back to x's dtype, before
    the taps (the pad stays zero). Returns ``y`` (N, H/2, W/2, Cout) in x's
    dtype, and with ``want_moments`` also ``(sum, sumsq)`` (N, Cout) f32 of
    the stored y.

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    (bf16: the TMA / wgmma kernel, counted also in ``.wgmma_launches``;
    f32: the CUDA-core one; both in ``.launches``) or raises; it also raises
    where autograd would record, since the kernel has no backward (the JAX
    kernel has none either: its route is inference-only)."""
    _check_args(x, weight, bias, prologue, act_pre, w_mode)
    args = (x, weight, bias, prologue, act_pre, w_mode, want_moments)
    if check_device("conv3x3s2_fused", x, [weight, bias, *(prologue or ())]):
        return conv3x3s2_fused_plain(*args)
    refuse_grad("conv3x3s2_fused", "--fused_updown is inference-only, as in JAX",
                x, weight, bias, *(prologue or ()))
    return _launch(*args)


conv3x3s2_fused.launches = 0
conv3x3s2_fused.wgmma_launches = 0
