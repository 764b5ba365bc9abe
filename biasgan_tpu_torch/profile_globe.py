"""Serving time and device-time breakdown of the full-globe forward on one
CUDA device, on four paths through the generator:

    python -m biasgan_tpu_torch.profile_globe [--out FILE.json]

* fused: --fused_blocks (the block convs through conv3x3_fused);
* plain: cuDNN convs, instance norms and pads;
* fused_all: --fused_blocks --fused_updown --conv7_pallas 1 (conv3x3_fused,
  conv3x3s2_fused, convt3x3s2_fused and conv7x7; no separate norm pass but
  the closing affines);
* plain_norm: --force_pallas_norm (the plain path with every norm through
  instance_norm_act).

The model is resnet_9blocks (ngf 64, instance norm, no dropout, periodic W,
bf16 compute) with random weights from a fixed seed, on a random
(1, 721, 1440, 3) field; the numbers do not depend on the values. Rounds
run the four paths in that order, twice, and each round measures:

* serve: FIELDS fields through ``infer.field_runner`` (standardize, pad,
  G, crop, destandardize) plus the copy to the host, each timed on the host
  clock between ``torch.cuda.synchronize()`` calls as ``infer.main`` times
  a field, after WARMUP fields;
* wall: FORWARDS back-to-back forwards of G on the padded field with one
  synchronize at the end, host ms per forward;
* profile: ``torch.profiler`` over PROFILED forwards: device busy ms per
  forward (the sum of the kernels' self device time), the largest kernels,
  the idle share 1 - busy / wall, and the launches of each hand-written
  kernel per forward;
* spans: ``torch.profiler`` over PROFILED served fields with the port's
  spans on (``trace.enabled()``): the host ms per field in each ``port.``
  span, and the CUDA runtime calls that block the host (SYNCS) inside
  ``port.serve.field_runner``: their count and host ms per field, by the
  two innermost spans they start in (a reflect or wrap pad's index upload
  shows as ``port.pad`` in its layer's span).

Then the 7x7 convs' input pads alone (``pad_hw`` as ``nn/layers.py``'s
``conv2d`` calls it: reflect 3 on H, wrap 3 on W, before the conv), at the
generator's globe shapes: the device ms per pad by ``torch.profiler`` over
PROFILED pads.

It prints one line per round and, with --out, writes every number to a
JSON file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter

import torch

from biasgan_tpu_torch import infer, trace
from biasgan_tpu_torch.kernels import launch_counts
from biasgan_tpu_torch.nn.factory import define_G
from biasgan_tpu_torch.ops.padding import pad_hw

GLOBE = (1, 721, 1440, 3)
FIELDS, WARMUP, FORWARDS, PROFILED, TOP = 20, 3, 10, 3, 14
# the 7x7 convs' inputs on the served globe: the stem's padded field (f32,
# cast to the compute dtype after the pad) and the head's (bf16, 64 channels)
PADS = {"stem": ((1, 724, 1440, 3), torch.float32),
        "head": ((1, 724, 1440, 64), torch.bfloat16)}
# the generator's routing attributes on each path
PATHS = {
    "fused": dict(fused_blocks=True),
    "plain": {},
    "fused_all": dict(fused_blocks=True, fused_updown=True, conv7=True),
    "plain_norm": dict(fused_norm=True),
}


# the CUDA runtime calls that block the host until the card catches up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")


def host_events(prof) -> list:
    """(name, start us, end us) of the profile's host events that
    ``serve_spans`` reads: the port's spans and the SYNCS calls."""
    from torch.autograd import DeviceType

    return [
        (e.name, e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CPU and (e.name.startswith("port.") or e.name in SYNCS)
    ]


def serve_spans(events, fields: int) -> dict:
    """From ``host_events`` of ``fields`` served fields: the host ms per
    field in each ``port.`` span, and the SYNCS calls that start inside a
    ``port.serve.field_runner``: their count and host ms per field, in all
    and by the two innermost spans they start in ("inner < outer")."""
    spans = [e for e in events if e[0].startswith("port.")]
    outer = [e for e in spans if e[0] == "port.serve.field_runner"]
    span_ms = Counter()
    for name, a, b in spans:
        span_ms[name] += (b - a) / 1e3 / fields
    count, blocked, where = 0, 0.0, {}
    for name, a, b in events:
        if name not in SYNCS or not any(x <= a <= y for _, x, y in outer):
            continue
        around = sorted((s for s in spans if s[1] <= a <= s[2]), key=lambda s: s[2] - s[1])
        key = " < ".join(s[0] for s in around[:2])
        n, ms = where.get(key, (0.0, 0.0))
        where[key] = (n + 1 / fields, ms + (b - a) / 1e3 / fields)
        count += 1
        blocked += (b - a) / 1e3
    return {"span_ms_per_field": dict(span_ms), "syncs_per_field": count / fields,
            "sync_ms_per_field": blocked / fields, "syncs_by_span": where}


def _device_rows(prof, forwards: int, top: int):
    """(busy ms per forward, [(ms per forward, calls per forward, kernel)])
    from the profiler's kernel events (user annotations excluded)."""
    from torch.autograd import DeviceType

    rows = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    busy = sum(e.self_device_time_total for e in rows) / forwards / 1e3
    rows.sort(key=lambda e: -e.self_device_time_total)
    return busy, [
        (e.self_device_time_total / forwards / 1e3, e.count / forwards, e.key[:100])
        for e in rows[:top]
    ]


def set_path(G, path: str) -> None:
    for attr in ("fused_blocks", "fused_updown", "conv7", "fused_norm"):
        setattr(G, attr, PATHS[path].get(attr, False))


def profile_round(G, x, path: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    set_path(G, path)
    multiples = infer.pad_multiples("resnet_9blocks")
    run = infer.field_runner(G, *multiples)
    zeros = torch.zeros(x.shape[-1], device=x.device)
    ones = torch.ones(x.shape[-1], device=x.device)
    stats = (zeros, ones, zeros, ones)

    for _ in range(WARMUP):
        run(x, *stats).cpu()
    serve_ms = []
    for _ in range(FIELDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(x, *stats).cpu()
        serve_ms.append((time.perf_counter() - t0) * 1e3)

    xp = infer.pad_field(x, *multiples)
    with torch.inference_mode():
        G(xp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FORWARDS):
            G(xp)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / FORWARDS
        before = launch_counts()
        with profile(activities=activities) as prof:
            for _ in range(PROFILED):
                G(xp)
            torch.cuda.synchronize()
        launches = {k: (v - before[k]) / PROFILED for k, v in launch_counts().items()}
    with trace.enabled(), profile(activities=activities) as spanned:
        for _ in range(PROFILED):
            run(x, *stats).cpu()
        torch.cuda.synchronize()
    busy, top = _device_rows(prof, PROFILED, TOP)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time for the forwards")
    return {
        "path": path,
        "serve_ms": serve_ms,
        "serve_median_ms": statistics.median(serve_ms),
        "serve_mean_ms": statistics.fmean(serve_ms),
        "serve_mpx_s": x.shape[1] * x.shape[2] / statistics.median(serve_ms) / 1e3,
        "wall_ms_per_forward": wall,
        "device_busy_ms_per_forward": busy,
        "idle_share": 1 - busy / wall,
        "launches_per_forward": launches,
        "top_kernels": top,
        "spans": serve_spans(host_events(spanned), PROFILED),
    }


def pad_round() -> dict:
    """Device ms per pad of each PADS input, with its kernels."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, (shape, dtype) in PADS.items():
        x = torch.randn(shape, device="cuda").to(dtype)
        pad_hw(x, (3, 3), (3, 3), "reflect", "wrap")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                pad_hw(x, (3, 3), (3, 3), "reflect", "wrap")
            torch.cuda.synchronize()
        busy, top = _device_rows(prof, PROFILED, 4)
        out[name] = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                     "device_ms": busy, "kernels": top}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="", help="write every number to this JSON file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_globe: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    G = define_G(
        "resnet_9blocks", GLOBE[3], GLOBE[3], ngf=64, norm="instance",
        w_mode="wrap", out_activation="none", compute_dtype=torch.bfloat16,
        generator=g,
    ).cuda().eval()
    x = torch.randn(GLOBE, generator=g).cuda()
    rounds = []
    for path in list(PATHS) * 2:
        r = profile_round(G, x, path)
        rounds.append(r)
        kernels = ", ".join(f"{k} {n:g}" for k, n in r["launches_per_forward"].items() if n)
        print(
            f"{r['path']}: serve median {r['serve_median_ms']:.3f} ms/field "
            f"(mean {r['serve_mean_ms']:.3f}, {FIELDS} fields, "
            f"{r['serve_mpx_s']:.2f} Mpx/s); wall {r['wall_ms_per_forward']:.3f} "
            f"ms/forward, device busy {r['device_busy_ms_per_forward']:.3f}, "
            f"idle share {r['idle_share']:.3f}; launches/forward: {kernels or 'none'}"
        )
        for ms, calls, key in r["top_kernels"]:
            print(f"  {ms:8.3f} ms/fwd {calls:6.1f} calls/fwd  {key}")
        sp = r["spans"]
        print(f"  spans: {sp['syncs_per_field']:g} host-blocking calls/field "
              f"({sp['sync_ms_per_field']:.3f} ms): "
              + (", ".join(f"{k} {n:g} ({ms:.3f} ms)"
                           for k, (n, ms) in sp["syncs_by_span"].items()) or "none")
              + "; host ms/field: "
              + ", ".join(f"{k} {ms:.3f}" for k, ms in sorted(sp["span_ms_per_field"].items())))
    pads = pad_round()
    for name, r in pads.items():
        print(f"{name} input pad {tuple(r['shape'])} {r['dtype']}: {r['device_ms']:.4f} device "
              "ms: " + ", ".join(f"{key} {ms:.4f}" for ms, _, key in r["kernels"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda,
                       "rounds": rounds, "pads": pads}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
