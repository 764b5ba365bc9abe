"""Fused up conv: torch ``ConvTranspose2d(3, stride 2, padding 1,
output_padding 1)`` on an NHWC input, the H axis zero padded and the W axis
periodic ('wrap') or zero padded, with an optional instance-norm +
activation prologue on the input and the per-(N, Cout) moments of the
output.

Counterpart of ``biasgan_tpu/ops/pallas_conv.py::convt3x3s2_fused`` (:1318)
followed by ``interleave_phases`` (:1813): the kernel writes the
(N, 2h, 2w, Cout) output itself. The kernels are CUDA C++ for sm_90a
(csrc/convt3x3s2_fused.cu, which says what bounds them and how they are
built up), compiled with nvcc on first use and bound with ctypes.

``convt3x3s2_fused`` takes its plain PyTorch version
(``convt3x3s2_fused_plain``) for a tensor on the CPU and launches a kernel
for a CUDA tensor; there is no fallback from one to the other. The rule
for a CUDA tensor: bf16 launches the TMA / wgmma kernel, f32 the
CUDA-core checker. The bf16 kernel loads x and stores y with TMA, which
needs C and Cout multiples of 8 and a 16-byte aligned x: the wrapper
zero-pads C up to a multiple of 8 (zero weights, zero prologue a and b:
act(0) = 0 adds nothing) and Cout likewise (zero weights and bias, the
extra couts sliced off y and the moments), and raises for a misaligned x.
``convt3x3s2_fused.launches`` counts every kernel launch,
``convt3x3s2_fused.wgmma_launches`` those of the bf16 kernel.

The bf16 kernel is an implicit GEMM of M = a tile's input pixels, N = the
four output phases by 64 couts, K = 64-channel blocks: each of its four
taps, the input shifted by (sy, sx) (``SLABS``), multiplies one K-major
weight slab into a contiguous range of the phases [ee | eo | oo | oe].
``pack_up_weight`` lays the IOHW weight out as those slabs.

As in the Pallas kernel, the moments are those of the stored, down-cast
output. The prologue is ``conv3x3_fused``'s (f32 a and b, f32 math, one
cast to x's dtype), where the Pallas wrapper computes it in x's dtype (see
conv3x3s2_fused.py). The weight is IOHW (the torch conv-transpose layout), not flipped. The
boundaries match ``nn.layers.conv_transpose2d``: the bottom halo row is
zero, the right halo column is column 0 under 'wrap' and zero otherwise.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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
from biasgan_tpu_torch.ops.padding import pad_axis

W_MODES = ("wrap", "zero")
KW = 64  # input channels per channel block of the bf16 kernel (one 128-byte row)
BN = 64  # couts of a bf16 unit: by the 4 output phases, 256 accumulator columns
TH, TW = 7, 18  # input rows and columns of the bf16 kernel's tile (126 pixels)
PHASES = ((0, 0), (0, 1), (1, 1), (1, 0))  # (py, px) of the accumulator's 64-column blocks
# the bf16 kernel's taps, in order: the input shift (sy, sx) and, per 64-row
# block of its slab, the IOHW tap (ky, kx) and the phase it adds into; a
# tap's phases are consecutive, so its product is one range of columns
SLABS = (
    ((0, 0), (((1, 1), 0), ((1, 2), 1), ((2, 2), 2), ((2, 1), 3))),
    ((0, 1), (((1, 0), 1), ((2, 0), 2))),
    ((1, 0), (((0, 2), 2), ((0, 1), 3))),
    ((1, 1), (((0, 0), 2),)),
)


def pack_up_weight(weight: torch.Tensor) -> torch.Tensor:
    """IOHW ``weight`` (C, Cout, 3, 3) as the bf16 kernel's B:
    (n_cob n_kc 576, 64), n_cob = Cout / 64 and n_kc = C / 64 rounded up;
    per (cout block, channel block) the nine 64-row blocks of ``SLABS`` in
    order, block (ky, kx) the K-major tap matrix W[64 cb .., 64 cob ..,
    ky, kx] (row: cout, column: channel), zero past C and past Cout. Pure
    data movement, so it gathers as well as it copies: ``_pack_index`` runs
    it on indices."""
    c, cout = weight.shape[:2]
    n_kc, n_cob = -(-c // KW), -(-cout // BN)
    w = F.pad(weight, (0, 0, 0, 0, 0, n_cob * BN - cout, 0, n_kc * KW - c))
    taps = torch.stack([w[:, :, ky, kx] for _, blocks in SLABS for (ky, kx), _ in blocks])
    taps = taps.reshape(9, n_kc, KW, n_cob, BN).permute(3, 1, 0, 4, 2)  # (cob, cb, 9, co, c)
    return taps.reshape(-1, KW).contiguous()


@functools.lru_cache(maxsize=32)
def _pack_index(c: int, cout: int, device: torch.device) -> torch.Tensor:
    """pack_up_weight as a gather: index 1 + i of the flat IOHW weight, 0
    where the packed slab holds a zero."""
    idx = torch.arange(1, c * cout * 9 + 1, dtype=torch.int64).reshape(c, cout, 3, 3)
    return pack_up_weight(idx).to(device)


def _packed_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """pack_up_weight(weight) in ``dtype`` on weight's device, as one
    gather from the flat weight with a zero in front."""
    c, cout = weight.shape[:2]
    flat = F.pad(weight.to(dtype).reshape(-1), (1, 0))
    return flat[_pack_index(c, cout, weight.device)]


def bf16_operands(x, weight, bias, prologue):
    """What the bf16 kernel takes for one call: ``(x, packed weight, bias,
    prologue, cout_k)``. C and Cout zero-padded to multiples of 8
    (``pad_channels``, ``pad_couts``; cout_k is Cout rounded up, which the
    caller slices off), the weight packed in x's dtype
    (``pack_up_weight``, one gather), and the prologue's a and b zero past
    C up to the kernel's 64-channel blocks."""
    x, wt, prologue = pad_channels(x, weight.transpose(0, 1), prologue)
    wt, bias = pad_couts(wt, bias)
    packed = _packed_weight(wt.transpose(0, 1), x.dtype)
    pad = -x.shape[3] % KW
    if prologue is not None and pad:
        prologue = tuple(F.pad(t, (0, pad)) for t in prologue)
    return x, packed, bias, prologue, wt.shape[0]


def _check_args(x, weight, bias, prologue, act_pre, w_mode) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if weight.ndim != 4 or weight.shape[0] != c or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"weight must be IOHW ({c}, Cout, 3, 3), got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[1],):
        raise ValueError(f"bias must be ({weight.shape[1]},), got {tuple(bias.shape)}")
    for t in prologue or ():
        if tuple(t.shape) != (n, c):
            raise ValueError(f"prologue tensors must be ({n}, {c}), got {tuple(t.shape)}")
    if act_pre not in ACT_CODE:
        raise ValueError(f"unknown act_pre {act_pre!r}")
    if w_mode not in W_MODES:
        raise ValueError(f"unknown w_mode {w_mode!r}; expected one of {W_MODES}")


def convt3x3s2_fused_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """Plain PyTorch version of ``convt3x3s2_fused``: the prologue, then
    the four output phases as products of the storage-dtype
    values accumulated in f32 (out(2m+py, 2j+px) from x(m+sy, j+sx) and
    W[ky, kx], see csrc/convt3x3s2_fused.cu), f32 bias, one cast, sums of
    the stored value. Set TF32 off to compare it with the kernel on the
    card."""
    _check_args(x, weight, bias, prologue, act_pre, w_mode)
    n, h, w, _ = x.shape
    cout = weight.shape[1]
    if prologue is not None:
        x = affine_act(x, *prologue, act_pre)
    # the bottom zero row and the right column (wrap or zero), after the
    # prologue
    xp = pad_axis(pad_axis(x, 1, 0, 1, "zero"), 2, 0, 1, w_mode).float()
    x00, x01 = xp[:, :h, :w], xp[:, :h, 1:]
    x10, x11 = xp[:, 1:, :w], xp[:, 1:, 1:]
    k = weight.to(x.dtype).float()

    def tap(v, ky, kx):
        return v @ k[:, :, ky, kx]

    ee = tap(x00, 1, 1)
    eo = tap(x01, 1, 0) + tap(x00, 1, 2)
    oe = tap(x10, 0, 1) + tap(x00, 2, 1)
    oo = tap(x11, 0, 0) + tap(x10, 0, 2) + tap(x01, 2, 0) + tap(x00, 2, 2)
    y = torch.stack([torch.stack([ee, eo], 3), torch.stack([oe, oo], 3)], 2)
    y = y.reshape(n, 2 * h, 2 * w, cout)
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    return (y, stored_moments(y)) if want_moments else y


_ARGTYPES = [PTR] * 8 + [INT] * 9


def _launch(x, weight, bias, prologue, act_pre, w_mode, want_moments):
    n, h, w, _ = x.shape
    cout = weight.shape[1]
    dtype = check_kernel_input("convt3x3s2_fused", x, 4 * n * h * w * cout)
    dev = x.device
    wgmma = x.dtype == torch.bfloat16
    cout_k = cout  # the kernel's Cout: a multiple of 8 for the bf16 kernel's TMA stores
    if wgmma:
        if x.data_ptr() % 16:
            raise ValueError("convt3x3s2_fused bf16 kernel needs a 16-byte aligned x "
                             "(TMA loads)")
        x, wk, bias, prologue, cout_k = bf16_operands(x, weight, bias, prologue)
        n_parts = sm_count(dev)  # a moment slot per block of the persistent grid
    else:
        # (9, C, Cout): tap ky * 3 + kx of the IOHW weight
        wk = weight.to(x.dtype).permute(2, 3, 0, 1).reshape(9, x.shape[3], cout).contiguous()
        n_parts = num_tiles("convt3x3s2_fused", "convt3x3s2_fused_num_tiles", h, w)
    b = None if bias is None else bias.float().contiguous()
    pa = pb = None
    if prologue is not None:
        pa, pb = (t.float().contiguous() for t in prologue)
        if wgmma and (pa.data_ptr() % 16 or pb.data_ptr() % 16):
            pa, pb = pa.clone(), pb.clone()  # the kernel loads them in 16-byte vectors
    y = torch.empty((n, 2 * h, 2 * w, cout_k), dtype=x.dtype, device=dev)
    part = moments = None
    if want_moments:
        part = torch.empty((2, n, n_parts, cout_k), dtype=torch.float32, device=dev)
        moments = torch.empty((2, n, cout_k), dtype=torch.float32, device=dev)
    launch(
        "convt3x3s2_fused", "convt3x3s2_fused_launch", _ARGTYPES, dev,
        ptr(x), ptr(wk), ptr(b), ptr(pa), ptr(pb), ptr(y), ptr(part), ptr(moments),
        n, h, w, x.shape[3], cout_k, n_parts, dtype, PAD_CODE[w_mode], ACT_CODE[act_pre],
    )
    convt3x3s2_fused.launches += 1
    convt3x3s2_fused.wgmma_launches += wgmma
    if cout_k != cout:
        y = y[..., :cout].contiguous()
    if not want_moments:
        return y
    return y, (moments[0, :, :cout], moments[1, :, :cout])


def convt3x3s2_fused(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """torch ``ConvTranspose2d(3, stride 2, padding 1, output_padding 1)``
    of NHWC ``x`` (N, H, W, C), f32 or bf16, with the IOHW ``weight``
    (C, Cout, 3, 3) cast to x's dtype and an optional f32 bias; ``w_mode``
    'wrap' makes W periodic, 'zero' pads it. ``prologue=(a, b)`` ((N, C)
    f32) makes the input ``act_pre(a*x + b)``, cast back to x's dtype.
    Returns
    ``y`` (N, 2H, 2W, Cout) in x's dtype, and with ``want_moments`` also
    ``(sum, sumsq)`` (N, Cout) f32 of the stored y.

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    (bf16: the TMA / wgmma kernel, counted also in ``.wgmma_launches``;
    f32: the CUDA-core one; both in ``.launches``) or raises; it also raises
    where autograd would record, since the kernel has no backward (the JAX
    kernel has none either: its route is inference-only)."""
    _check_args(x, weight, bias, prologue, act_pre, w_mode)
    args = (x, weight, bias, prologue, act_pre, w_mode, want_moments)
    if check_device("convt3x3s2_fused", x, [weight, bias, *(prologue or ())]):
        return convt3x3s2_fused_plain(*args)
    refuse_grad("convt3x3s2_fused", "--fused_updown is inference-only, as in JAX",
                x, weight, bias, *(prologue or ()))
    return _launch(*args)


convt3x3s2_fused.launches = 0
convt3x3s2_fused.wgmma_launches = 0
