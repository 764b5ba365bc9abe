"""The fused block conv's backward kernel (K2's, ``kernels/conv3x3_fused.py``
``conv3x3_fused_bwd``) on one CUDA device, call by call, at the shapes the
training step gives it:

    python biasgan_tpu_torch/profile_fused_bwd.py [--tree DIR] [--out FILE.json]

It runs as a file, so that ``--tree`` can put another checkout's package
first on the import path (a parent commit unpacked with ``git archive``,
to time both trees in one call); by default, the checkout that holds it.

The shapes, bf16, on seeded inputs, with the prologue (ReLU), the bias and
the moments' cotangents, as ``_FusedT.backward`` calls it on the
``--fused_blocks`` routes: (B, 64, 64, 256) -> 256 at B 2, 3 and 1 (the
256x256 CycleGAN step at batch 1: 18 calls each; H reflect, W wrap) and
the halo W mode of ``--spatial_mesh 4`` (B, 64, 16 + 2, 256) -> 256 at
the same batches (18 calls each per rank). At each:

* ms per call under CUDA events, the best of three runs of ITERS calls
  after WARMUP calls;
* device ms per call by kernel from ``torch.profiler`` over ITERS calls,
  checked: a profile of one call gives the kernels a call runs, and the
  profile of the ITERS calls must hold ITERS times that many kernel events
  (torch.profiler has lost or doubled a call's events in some profiles);
  a profile that does not is taken again, up to PROFILE_TRIES times, and
  the shape reads null where none held;
* host us per call: the host clock around HOST_CALLS calls issued back to
  back with no synchronize in between (the wrapper's Python, its
  allocations and the launches), after a synchronize: the card idle at
  the first call; the best of HOST_RUNS runs.

It prints a line per shape and the per-step sums (device ms by kernel
times the calls per step), and with --out writes every number to a JSON
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

ITERS, WARMUP, HOST_CALLS, HOST_RUNS, PROFILE_TRIES = 20, 3, 20, 5, 3
# (x's shape, Cout, W mode, calls per step)
SHAPES = ([((b, 64, 64, 256), 256, "wrap", 18) for b in (2, 3, 1)]
          + [((b, 64, 18, 256), 256, "halo", 18) for b in (2, 3, 1)])


def _kernel_events(torch, fn, calls):
    """The profile of ``calls`` calls of ``fn`` after a synchronize:
    (ms per call by kernel name, the number of kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(("Memcpy", "Memset"))]
    out = {}
    for e in events:
        k = re.sub(r"^void |\(anonymous namespace\)::|port::conv_tma::", "", e.name)[:48]
        out[k] = out.get(k, 0.0) + e.device_time_total / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1])), len(events)


def checked_device_ms(torch, fn) -> dict:
    """Device ms per call by kernel over ITERS calls, from a profile that
    holds ITERS times the kernel events of one call (see the docstring)."""
    fn()
    per_call = _kernel_events(torch, fn, 1)[1]
    tries = []
    for _ in range(PROFILE_TRIES):
        by_kernel, events = _kernel_events(torch, fn, ITERS)
        tries.append(events)
        if per_call > 0 and events == ITERS * per_call:
            return {"device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel,
                    "kernels_per_call": per_call, "profile_events": tries}
    return {"device_ms": None, "device_ms_by_kernel": {}, "kernels_per_call": per_call,
            "profile_events": tries}


def event_ms(torch, fn) -> float:
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


def host_us(torch, fn) -> float:
    """us of host time per call, HOST_CALLS calls back to back: the best of
    HOST_RUNS runs."""
    best = float("inf")
    for _ in range(HOST_RUNS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, (time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return best


def bwd_args(torch, g, shape, cout, w_mode):
    """The arguments of one training call: x (with its halo columns in the
    halo mode, those a periodic ring brings), the OIHW weight, bias, the
    prologue's a and b, the stored y and the cotangents of y and its
    moments."""
    n, h, w, c = shape
    x = torch.randn(shape, generator=g, device="cuda")
    if w_mode == "halo":
        x[:, :, 0], x[:, :, -1] = x[:, :, -2].clone(), x[:, :, 1].clone()
        w -= 2
    bf = torch.bfloat16
    return (x.to(bf), (torch.randn((cout, c, 3, 3), generator=g, device="cuda")
                       * (9 * c) ** -0.5).to(bf),
            0.1 * torch.randn(cout, generator=g, device="cuda"),
            0.5 + torch.rand((n, c), generator=g, device="cuda"),
            0.5 * torch.randn((n, c), generator=g, device="cuda"),
            torch.randn((n, h, w, cout), generator=g, device="cuda").to(bf),
            torch.randn((n, h, w, cout), generator=g, device="cuda").to(bf),
            torch.randn((n, cout), generator=g, device="cuda"),
            0.01 * torch.randn((n, cout), generator=g, device="cuda"),
            "relu", "reflect", w_mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose biasgan_tpu_torch to import (default: this one)")
    ap.add_argument("--out", help="write every number to this JSON file")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("profile_fused_bwd: needs a CUDA device", file=sys.stderr)
        return 2
    from biasgan_tpu_torch.kernels import conv3x3_fused as k2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"{card}; tree {os.path.abspath(args.tree)}; module {k2.__file__}")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape, cout, w_mode, count in SHAPES:
        a = bwd_args(torch, g, shape, cout, w_mode)

        def fn():
            return k2.conv3x3_fused_bwd(*a)

        row = {"shape": list(shape), "cout": cout, "w_mode": w_mode, "count": count,
               "ms": event_ms(torch, fn), **checked_device_ms(torch, fn),
               "host_us": host_us(torch, fn)}
        rows.append(row)
        dev = row["device_ms"]
        print(f"{shape} -> {cout} {w_mode} x{count}: {row['ms']:.4f} ms (CUDA events), "
              + ("device not read: no profile held the call's kernel events "
                 f"{row['profile_events']}" if dev is None else
                 f"{dev:.4f} on the card (" + ", ".join(
                     f"{k} {t:.4f}" for k, t in row["device_ms_by_kernel"].items()) + ")")
              + f", host {row['host_us']:.1f} us a call")
    for w_mode in ("wrap", "halo"):
        mine = [r for r in rows if r["w_mode"] == w_mode]
        step = {"ms": sum(r["ms"] * r["count"] for r in mine),
                "host_ms": sum(r["host_us"] * r["count"] for r in mine) / 1e3}
        if all(r["device_ms"] is not None for r in mine):
            step["device_ms"] = sum(r["device_ms"] * r["count"] for r in mine)
            by = {}
            for r in mine:
                for k, t in r["device_ms_by_kernel"].items():
                    by[k] = by.get(k, 0.0) + t * r["count"]
            step["device_ms_by_kernel"] = by
        print(f"per step ({w_mode}, {sum(r['count'] for r in mine)} calls): {json.dumps(step)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": torch.cuda.get_device_name(0),
                       "tree": os.path.abspath(args.tree), "calls": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
