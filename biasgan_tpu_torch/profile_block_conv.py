"""Device time of the block conv's bf16 kernel (K1, kernels/csrc/
conv3x3_fused.cu) at its main path's shapes, for each tile width the
wrapper can pick, on one CUDA device:

    python -m biasgan_tpu_torch.profile_block_conv [--out FILE.json]

Shapes: the full-globe block conv (1, 181, 360, 256) -> 256 with and
without the prologue, the 4-way W shard's halo mode (1, 181, 90 + 2, 256)
and the 256x256 CycleGAN step's forwards (B, 64, 64, 256), B 1, 2, 3, with
the prologue. For each shape and tile width (128 or 256 couts): the
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
from biasgan_tpu_torch.kernels.common import sm_count

ITERS = 20
# (n, h, w, c, cout), prologue, w_mode
SHAPES = [((1, 181, 360, 256, 256), True, "wrap"), ((1, 181, 360, 256, 256), False, "wrap"),
          ((1, 181, 90, 256, 256), True, "halo")] + [
    ((b, 64, 64, 256, 256), True, "reflect") for b in (1, 2, 3)]


@contextlib.contextmanager
def _tile_couts(bn: int):
    """The wrapper's tile width fixed at ``bn`` for the calls inside."""
    pick = k1.tile_geometry
    k1.tile_geometry = lambda *args: bn
    try:
        yield
    finally:
        k1.tile_geometry = pick


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
    tiles = n * -(-h // k1.TH) * -(-w // k1.TW)
    row = {"shape": list(shape), "prologue": prologue, "w_mode": w_mode,
           "picked": k1.tile_geometry(n, h, w, cout, sms)}
    for bn in (128, 256):
        with _tile_couts(bn), torch.no_grad():
            ms = _kernel_ms(lambda: k1.conv3x3_fused(*args))
        row[f"bn{bn}"] = {"rounds": -(-tiles * -(-cout // bn) // sms), "device_ms": ms}
    row["half_tile_cost"] = ((row["bn128"]["device_ms"] / row["bn128"]["rounds"])
                             / (row["bn256"]["device_ms"] / row["bn256"]["rounds"]))
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the numbers to this JSON file")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_block_conv: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = sm_count(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = [profile_shape(shape, pro, w_mode, g, sms) for shape, pro, w_mode in SHAPES]
    for r in rows:
        print(f"{tuple(r['shape'])} prologue {r['prologue']} {r['w_mode']}: "
              + "; ".join(f"{k} {r[k]['rounds']} rounds {r[k]['device_ms']:.4f} ms"
                          for k in ("bn128", "bn256"))
              + f"; picked {r['picked']}; a 128-cout round / a 256-cout round "
              f"{r['half_tile_cost']:.3f} on {card}, {sms} SMs")
    result = {"card": card, "sms": sms, "half_tile_cost_used": k1.HALF_TILE_COST, "rows": rows}
    if opt.out:
        with open(opt.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
