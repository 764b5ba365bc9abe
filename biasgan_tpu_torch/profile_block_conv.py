"""Device time of the block conv's bf16 kernel (K1, kernels/csrc/
conv3x3_fused.cu) at its main path's shapes, for each tile width the
wrapper can pick, on one CUDA device:

    python -m biasgan_tpu_torch.profile_block_conv [--valid] [--out FILE.json]

Shapes: the full-globe block conv (1, 181, 360, 256) -> 256 with and
without the prologue, the 4-way W shard's halo mode (1, 181, 90 + 2, 256)
and the 256x256 CycleGAN step's forwards (B, 64, 64, 256), B 1, 2, 3, with
the prologue. With ``--valid``, the VALID conv's bf16 kernel (K6,
kernels/csrc/conv3x3_valid.cu, K1's tile loop) instead: the globe block
shape (1, 183, 362, 256) -> 256 with bias, and the CycleGAN step's
forwards (B, 66, 66, 256) and input gradients (the cotangent
(B, 64, 64, 256) -> (B, 66, 66, 256)), B 1, 2, 3. For each shape and tile
width (128 or 256 couts): the
rounds of the persistent grid on this card's SMs, and the kernel's device
ms per call (torch.profiler over ITERS calls after a warm-up, the conv
kernel alone: no weight pack or moment sum). Per shape, the width
``tile_geometry`` picks, and the time of a 128-cout round against a
256-cout one, the ratio that ``HALF_TILE_COST`` stands for.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import torch

from biasgan_tpu_torch.kernels import conv3x3_fused as k1
from biasgan_tpu_torch.kernels import conv3x3_valid as k6
from biasgan_tpu_torch.kernels import conv_tma
from biasgan_tpu_torch.kernels.common import sm_count

ITERS = 20
# (n, h, w, c, cout), prologue, w_mode
SHAPES = [((1, 181, 360, 256, 256), True, "wrap"), ((1, 181, 360, 256, 256), False, "wrap"),
          ((1, 181, 90, 256, 256), True, "halo")] + [
    ((b, 64, 64, 256, 256), True, "reflect") for b in (1, 2, 3)]
# K6: (n, h, w, c, cout) of the output, bias, input gradient
VALID_SHAPES = [((1, 181, 360, 256, 256), True, False)] + [
    ((b, h, h, 256, 256), False, dx) for dx, h in ((False, 64), (True, 66)) for b in (1, 2, 3)]


@contextlib.contextmanager
def _tile_couts(bn: int):
    """The wrappers' tile width fixed at ``bn`` for the calls inside."""
    pick = conv_tma.tile_geometry
    conv_tma.tile_geometry = lambda *args: bn
    try:
        yield
    finally:
        conv_tma.tile_geometry = pick


def _kernel_ms(fn) -> float:
    """Device ms per call of the conv kernel (conv_tma_kernel) in ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if "conv_tma_kernel" in e.name) / 1e3 / ITERS


def profile_shape(shape, prologue: bool, w_mode: str, g, sms: int) -> dict:
    n, h, w, c, cout = shape
    dev = torch.device("cuda")
    x = torch.randn((n, h, w + 2 * (w_mode == "halo"), c), generator=g, device=dev)
    wt = torch.randn((cout, c, 3, 3), generator=g, device=dev) * (9 * c) ** -0.5
    bias = 0.1 * torch.randn((cout,), generator=g, device=dev)
    pro = None
    if prologue:
        pro = (0.5 + torch.rand((n, c), generator=g, device=dev),
               0.5 * torch.randn((n, c), generator=g, device=dev))
    args = (x.bfloat16(), wt.bfloat16(), bias, pro, "relu", "reflect", w_mode, True)
    row = {"shape": list(shape), "prologue": prologue, "w_mode": w_mode}
    return _by_width(row, shape, lambda: k1.conv3x3_fused(*args), sms)


def profile_valid_shape(shape, bias: bool, dx: bool, g, sms: int) -> dict:
    """K6 at output ``shape``: the forward on the padded input, or with
    ``dx`` the input gradient of the cotangent (n, h - 2, w - 2, cout)."""
    n, h, w, c, cout = shape
    dev = torch.device("cuda")
    wt = (torch.randn((cout, c, 3, 3), generator=g, device=dev) * (9 * c) ** -0.5).bfloat16()
    if dx:  # the forward's weight is (C_fwd, Cout_fwd) = (cout, c) here
        gy = torch.randn((n, h - 2, w - 2, c), generator=g, device=dev).bfloat16()
        wt = wt.transpose(0, 1).contiguous()
        fn = lambda: k6.conv3x3_valid_dx(gy, wt)
    else:
        xp = torch.randn((n, h + 2, w + 2, c), generator=g, device=dev).bfloat16()
        b = 0.1 * torch.randn((cout,), generator=g, device=dev) if bias else None
        fn = lambda: k6.conv3x3_valid(xp, wt, b)
    row = {"shape": list(shape), "bias": bias, "input_grad": dx}
    return _by_width(row, shape, fn, sms)


def _by_width(row: dict, shape, fn, sms: int) -> dict:
    """``row`` with the kernel's device ms per call of ``fn`` (output
    ``shape``) at each tile width, its rounds, the width the wrapper picks,
    and the half-tile ratio."""
    n, h, w, _, cout = shape
    tiles = n * -(-h // conv_tma.TH) * -(-w // conv_tma.TW)
    row["picked"] = conv_tma.tile_geometry(n, h, w, cout, sms)
    for bn in (128, 256):
        with _tile_couts(bn), torch.no_grad():
            ms = _kernel_ms(fn)
        row[f"bn{bn}"] = {"rounds": -(-tiles * -(-cout // bn) // sms), "device_ms": ms}
    row["half_tile_cost"] = ((row["bn128"]["device_ms"] / row["bn128"]["rounds"])
                             / (row["bn256"]["device_ms"] / row["bn256"]["rounds"]))
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--valid", action="store_true",
                    help="time the VALID conv (K6) at its shapes instead of K1")
    ap.add_argument("--out", help="write the numbers to this JSON file")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_block_conv: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = sm_count(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    if opt.valid:
        rows = [profile_valid_shape(shape, bias, dx, g, sms) for shape, bias, dx in VALID_SHAPES]
    else:
        rows = [profile_shape(shape, pro, w_mode, g, sms) for shape, pro, w_mode in SHAPES]
    for r in rows:
        what = (f"input grad {r['input_grad']} bias {r['bias']}" if opt.valid
                else f"prologue {r['prologue']} {r['w_mode']}")
        print(f"{tuple(r['shape'])} {what}: "
              + "; ".join(f"{k} {r[k]['rounds']} rounds {r[k]['device_ms']:.4f} ms"
                          for k in ("bn128", "bn256"))
              + f"; picked {r['picked']}; a 128-cout round / a 256-cout round "
              f"{r['half_tile_cost']:.3f} on {card}, {sms} SMs")
    result = {"card": card, "sms": sms, "kernel": "K6 conv3x3_valid" if opt.valid else
              "K1 conv3x3_fused", "half_tile_cost_used": conv_tma.HALF_TILE_COST, "rows": rows}
    if opt.out:
        with open(opt.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
