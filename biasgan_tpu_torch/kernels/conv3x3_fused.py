"""Fused resnet-block conv: SAME 3x3 stride-1 conv with the pad built in the
kernel, an optional instance-norm + activation prologue on the input, and
the per-(N, Cout) moments of the output.

Counterpart of ``biasgan_tpu/ops/pallas_conv.py::conv3x3_fused`` (:771) and
its helpers ``instance_moments_to_affine`` (:541) / ``apply_affine`` (:553).
The kernel is CUDA C++ for sm_90a (csrc/conv3x3_fused.cu, which says what
bounds it and how it is built up), compiled with nvcc on first use and
bound with ctypes (kernels/build.py).

``conv3x3_fused`` takes its plain PyTorch version (pad + f32 ``F.conv2d`` +
sums, ``conv3x3_fused_plain``) for a tensor on the CPU, and launches the
kernel for a CUDA tensor; there is no fallback from one to the other.
``conv3x3_fused.launches`` counts the kernel launches.

Differences from the Pallas wrapper: the input is at its logical height
(no ``h_run`` tail: the kernel masks ragged tiles itself), there is no plan
argument (the tiling is the kernel's own), and the weight is OIHW. The
``halo`` W mode waits for the spatial-sharding part of the port.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from biasgan_tpu_torch.ops.padding import pad_hw

_PAD_CODE = {"zero": 0, "reflect": 1, "wrap": 2}
_ACT_CODE = {"none": 0, "relu": 1, "lrelu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

def instance_moments_to_affine(
    msum: torch.Tensor, msq: torch.Tensor, count: int, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum^2) per (N, C) -> the instance-norm affine (a, b) with
    y_norm = y*a + b. Matches nn.layers.instance_norm: f32 stats, biased
    variance via max(E[x^2] - E[x]^2, 0)."""
    mean = msum / count
    var = torch.clamp(msq / count - mean.square(), min=0.0)
    a = torch.rsqrt(var + eps)
    return a, -mean * a


def apply_affine(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """Per-(N, C) instance-norm affine on an NHWC conv output: f32 math,
    optional ReLU, cast back to y.dtype — the elementwise pass that closes a
    fused-kernel chain."""
    yn = y.float() * a[:, None, None, :] + b[:, None, None, :]
    if relu:
        yn = torch.clamp(yn, min=0.0)
    return yn.to(y.dtype)


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp(x, min=0.0)
    if act == "lrelu":
        return torch.where(x > 0, x, 0.2 * x)
    return x


def _check_args(x, weight, bias, prologue, act_pre, h_mode, w_mode) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(
            f"weight must be OIHW (Cout, {c}, 3, 3), got {tuple(weight.shape)}"
        )
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
    if prologue is not None:
        for t in prologue:
            if tuple(t.shape) != (n, c):
                raise ValueError(f"prologue tensors must be ({n}, {c}), got {tuple(t.shape)}")
    if act_pre not in _ACT_CODE:
        raise ValueError(f"unknown act_pre {act_pre!r}")
    for name, mode, size in (("h_mode", h_mode, h), ("w_mode", w_mode, w)):
        if mode not in _PAD_CODE:
            raise ValueError(f"unknown {name} {mode!r}; expected one of {sorted(_PAD_CODE)}")
        if mode == "reflect" and size < 2:
            raise ValueError(f"{name}='reflect' needs a size of at least 2, got {size}")


def conv3x3_fused_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    h_mode: str = "reflect",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """Plain PyTorch version of ``conv3x3_fused``: prologue, pad, then the
    conv of the storage-dtype values accumulated in f32 (as the kernel and
    the Pallas kernel accumulate: a bf16 cuDNN conv rounds differently and
    moves the moments by ~1e-3), f32 bias, one cast, sums of the stored
    value. Set TF32 off to compare it with the kernel on the card."""
    _check_args(x, weight, bias, prologue, act_pre, h_mode, w_mode)
    if prologue is not None:
        a, b = prologue
        xf = x.float() * a[:, None, None, :].float() + b[:, None, None, :].float()
        # cast back to the storage dtype before the taps, as the kernel does
        x = _act(xf, act_pre).to(x.dtype)
    xp = pad_hw(x, (1, 1), (1, 1), h_mode, w_mode)
    w = weight.to(x.dtype).float()
    y = F.conv2d(xp.permute(0, 3, 1, 2).float(), w).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    if not want_moments:
        return y
    yf = y.float()
    return y, (yf.sum(dim=(1, 2)), yf.square().sum(dim=(1, 2)))


def _library() -> ctypes.CDLL:
    from biasgan_tpu_torch.kernels import build

    lib = build.load("conv3x3_fused")
    if not getattr(lib, "_conv3x3_fused_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_fused_launch.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.conv3x3_fused_launch.restype = i
        lib.conv3x3_fused_num_tiles.argtypes = [i, i, i]
        lib.conv3x3_fused_num_tiles.restype = i
        lib.conv3x3_fused_error_string.argtypes = [i]
        lib.conv3x3_fused_error_string.restype = ctypes.c_char_p
        lib._conv3x3_fused_bound = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(x, weight, bias, prologue, act_pre, h_mode, w_mode, want_moments):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv3x3_fused kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_fused kernel needs a contiguous NHWC x")
    n, h, w, c = x.shape
    cout = weight.shape[0]
    if max(x.numel(), n * h * w * cout) >= 2**31:
        raise ValueError("conv3x3_fused kernel indexes tensors below 2**31 elements")
    dev = x.device
    tensors = [weight] + ([] if bias is None else [bias]) + list(prologue or ())
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"conv3x3_fused: tensor on {t.device}, x on {dev}")
    # weight as (9, C, Cout) in x's dtype: the Pallas wrapper's w9
    w9 = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(9, c, cout).contiguous()
    b = None if bias is None else bias.float().contiguous()
    pa = pb = None
    if prologue is not None:
        pa, pb = (t.float().contiguous() for t in prologue)
    lib = _library()
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
    part = moments = None
    if want_moments:
        tiles = lib.conv3x3_fused_num_tiles(h, w, _DTYPE_CODE[x.dtype])
        part = torch.empty((2, n, tiles, cout), dtype=torch.float32, device=dev)
        moments = torch.empty((2, n, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conv3x3_fused_launch(
            _ptr(x), _ptr(w9), _ptr(b), _ptr(pa), _ptr(pb), _ptr(y),
            _ptr(part), _ptr(moments),
            n, h, w, c, cout, _DTYPE_CODE[x.dtype],
            _PAD_CODE[h_mode], _PAD_CODE[w_mode], _ACT_CODE[act_pre],
            stream,
        )
    if err != 0:
        msg = lib.conv3x3_fused_error_string(err).decode()
        raise RuntimeError(f"conv3x3_fused kernel launch failed: CUDA error {err} ({msg})")
    conv3x3_fused.launches += 1
    if not want_moments:
        return y
    return y, (moments[0], moments[1])


def conv3x3_fused(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act_pre: str = "relu",
    h_mode: str = "reflect",
    w_mode: str = "wrap",
    want_moments: bool = True,
):
    """SAME 3x3 s1 conv of NHWC ``x`` (N, H, W, C), f32 or bf16, with the
    OIHW ``weight`` (Cout, C, 3, 3) cast to x's dtype, an optional f32 bias,
    and optional ``prologue=(a, b)`` ((N, C) f32): the input becomes
    ``act_pre(a*x + b)`` cast back to x's dtype before the taps.

    ``h_mode`` in reflect/zero/wrap and ``w_mode`` in wrap/reflect/zero
    build the SAME pad (after the prologue: a zero pad is a zero of the
    normalized input). Returns ``y`` (N, H, W, Cout) in x's dtype, and with
    ``want_moments`` also ``(sum, sumsq)`` (N, Cout) f32 of the stored y.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts it in ``conv3x3_fused.launches``) or raises."""
    _check_args(x, weight, bias, prologue, act_pre, h_mode, w_mode)
    if x.device.type == "cpu":
        return conv3x3_fused_plain(
            x, weight, bias, prologue, act_pre, h_mode, w_mode, want_moments
        )
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fused runs on cpu or cuda tensors, got {x.device}")
    return _launch(x, weight, bias, prologue, act_pre, h_mode, w_mode, want_moments)


conv3x3_fused.launches = 0
