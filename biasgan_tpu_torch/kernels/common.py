"""What the kernel wrappers share: the integer codes of the C interfaces,
the plain-version helpers (activations, the prologue in the input's dtype,
the moments of a stored output) and the launch of a kernel library's entry
point on the current stream.

A wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor; it raises on any other device and never falls back.

A launch writes into a ``torch.empty`` output that autograd knows nothing
of. So where autograd records (``wants_grad``), a wrapper goes through its
``torch.autograd.Function`` or, for a kernel with no backward, raises on the
card (``refuse_grad``): it never returns a result with no ``grad_fn``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

PAD_CODE = {"zero": 0, "reflect": 1, "wrap": 2}
ACT_CODE = {"none": 0, "relu": 1, "lrelu": 2}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def act_f32(x: torch.Tensor, act: str) -> torch.Tensor:
    """none / relu / lrelu(0.2) on f32 values."""
    if act == "relu":
        return torch.clamp(x, min=0.0)
    if act == "lrelu":
        return torch.where(x > 0, x, 0.2 * x)
    return x


def affine_act(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, act: str
) -> torch.Tensor:
    """The fused convs' prologue: act(a*x + b) per (N, C) on NHWC ``x``,
    with a and b in f32 and the math in f32, cast back to x's dtype once
    (so a bf16 input rounds once, before the taps)."""
    xf = x.float() * a[:, None, None, :].float() + b[:, None, None, :].float()
    return act_f32(xf, act).to(x.dtype)


def stored_moments(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares) per (N, C) of NHWC ``y`` as stored, in f32."""
    yf = y.float()
    return yf.sum(dim=(1, 2)), yf.square().sum(dim=(1, 2))


def check_device(name: str, x: torch.Tensor, others: Sequence[Optional[torch.Tensor]]):
    """Whether the plain version runs (x on the CPU); raises for a device
    other than cpu or cuda and for tensors on another device than x."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {x.device}")
    for t in others:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: tensor on {t.device}, x on {x.device}")
    return x.device.type == "cpu"


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records a call on these tensors: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def refuse_grad(name: str, why: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where a kernel with no backward would return a result that
    autograd cannot follow."""
    if wants_grad(*tensors):
        raise RuntimeError(f"{name} kernel has no backward ({why}); call it under "
                           "torch.no_grad() or torch.inference_mode()")


def check_kernel_input(name: str, x: torch.Tensor, out_numel: int) -> int:
    """The kernel's dtype code for ``x``; raises on what the kernels do not
    take."""
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous NHWC x")
    if max(x.numel(), out_numel) >= 2**31:
        raise ValueError(f"{name} kernel indexes tensors below 2**31 elements")
    return DTYPE_CODE[x.dtype]


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(name: str, fn: str, argtypes: Sequence, device: torch.device, *args) -> None:
    """Call ``fn`` of kernel library ``name`` (built on first use) with
    ``args`` and the device's current stream; raise on a CUDA error."""
    from biasgan_tpu_torch.kernels import build

    lib = build.load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = list(argtypes) + [PTR]
        f.restype = INT
        lib.port_error_string.argtypes = [INT]
        lib.port_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        err = f(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.port_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def num_tiles(name: str, fn: str, *args: int) -> int:
    """An integer query of kernel library ``name`` (the tile count of its
    moment partials)."""
    from biasgan_tpu_torch.kernels import build

    f = getattr(build.load(name), fn)
    f.argtypes = [INT] * len(args)
    f.restype = INT
    return f(*args)
