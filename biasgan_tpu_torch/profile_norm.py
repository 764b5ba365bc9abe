"""The instance norm kernel's forward (K7, ``kernels/instance_norm_act.py``)
on one CUDA device, call by call, at the shapes its main paths give it:

    python biasgan_tpu_torch/profile_norm.py [--tree DIR] [--out FILE.json]

It runs as a file, so that ``--tree`` can put another checkout's package
first on the import path (a parent commit unpacked with ``git archive``,
to time both trees in one call); by default, the checkout that holds it.

The shapes, bf16, on seeded inputs: the globe's four (resnet_9blocks on a
721x1440 field under --force_pallas_norm, with their calls per field) and
the 256x256 CycleGAN step's at batch 1 on the all-kernel route (the
generators' non-block norms at batch 2, 3 and 1, the discriminators' at
batch 1 and 2, with their calls per step). At each:

* ms per call under CUDA events, the best of three runs of ITERS calls
  after WARMUP calls;
* device ms per call by kernel from ``torch.profiler`` over ITERS calls:
  what the card ran, apart from the host's work;
* host us per call: the host clock around HOST_CALLS calls issued back to
  back with no synchronize in between (the wrapper's Python, its
  allocations and the launch), after a synchronize;
* where the tree's wrapper has ``plan_for`` (the one-launch kernel): the
  path the plan names, and at a shape the cluster path takes, the same
  numbers with ``persistent=True``.

It prints a line per shape and, with --out, writes every number to a JSON
file.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ITERS, WARMUP, HOST_CALLS = 20, 3, 50
# (shape, activation, residual, calls per field)
GLOBE_NORMS = [((1, 724, 1440, 64), "relu", False, 2),
               ((1, 362, 720, 128), "relu", False, 2),
               ((1, 181, 360, 256), "relu", False, 10),
               ((1, 181, 360, 256), "none", True, 9)]


def train_norms(b_g=(2, 3, 1), b_d=((1, 2), (2, 2))):
    """The instance norms of the all-kernel training route per step, as
    (shape, activation, residual, calls): the five non-block norms of each
    generator dispatch (batch b_g; the 18 block norms are inside the fused
    block convs) and the three of each discriminator forward ((batch,
    forwards) in b_d)."""
    out = []
    for b in b_g:
        out += [((b, 256, 256, 64), "relu", False, 2), ((b, 128, 128, 128), "relu", False, 2),
                ((b, 64, 64, 256), "relu", False, 1)]
    for b, n in b_d:
        out += [((b, 64, 64, 128), "lrelu", False, n), ((b, 32, 32, 256), "lrelu", False, n),
                ((b, 31, 31, 512), "lrelu", False, n)]
    return out


def _device_ms(torch, fn, iters=ITERS) -> dict:
    """ms per call on the card by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(
                ("Memcpy", "Memset")):
            k = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)[:48]
            out[k] = out.get(k, 0.0) + e.device_time_total / 1e3 / iters
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _event_ms(torch, fn) -> float:
    """Best of three: ms per call under CUDA events over ITERS calls."""
    best = float("inf")
    for _ in range(3):
        for _ in range(WARMUP):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / ITERS)
    return best


def _host_us(torch, fn) -> float:
    """us of host time per call, HOST_CALLS calls back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / HOST_CALLS * 1e6


def measure(torch, k7, shape, act, res, g) -> dict:
    """Every number of one shape, on each path the tree's wrapper has."""
    x = (3 * torch.randn(shape, generator=g, device="cuda") + 1).to(torch.bfloat16)
    r = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) if res else None
    paths = {"default": {}}
    if hasattr(k7, "plan_for"):
        paths = {k7.plan_for(x).path: {}}
        if "cluster" in paths:
            paths["persistent"] = {"persistent": True}
    out = {}
    with torch.no_grad():
        for path, kw in paths.items():
            def fn():
                return k7.instance_norm_act(x, r, act, **kw)

            device = _device_ms(torch, fn)
            out[path] = {"ms": _event_ms(torch, fn), "device_ms": sum(device.values()),
                         "device_ms_by_kernel": device, "host_us": _host_us(torch, fn)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose biasgan_tpu_torch to import (default: this one)")
    ap.add_argument("--out", help="write every number to this JSON file")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("profile_norm: needs a CUDA device", file=sys.stderr)
        return 2
    from biasgan_tpu_torch.kernels import instance_norm_act as k7

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"{card}; tree {os.path.abspath(args.tree)}; module {k7.__file__}")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for where, calls in (("globe", GLOBE_NORMS), ("train", train_norms())):
        for shape, act, res, count in calls:
            got = measure(torch, k7, shape, act, res, g)
            rows.append({"where": where, "shape": list(shape), "act": act, "residual": res,
                         "count": count, "paths": got})
            print(f"{where} {shape} {act}{' + residual' if res else ''} x{count}: " + "; ".join(
                f"{p}: {v['ms']:.4f} ms (CUDA events), {v['device_ms']:.4f} on the card ("
                + ", ".join(f"{k} {t:.4f}" for k, t in v["device_ms_by_kernel"].items())
                + f"), host {v['host_us']:.1f} us a call" for p, v in got.items()))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": torch.cuda.get_device_name(0),
                       "tree": os.path.abspath(args.tree), "calls": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
