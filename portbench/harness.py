"""What every cell of the bench shares: the cell's files, seeds, seeded
weights on the card, the device block of the result line, the reduction of
a profiler trace to busy time and a breakdown, and the check that no JAX
module was loaded.

A cell is ``workloads/<cell>.json`` (its configuration, traffic, chips,
route and the limits of its check), the configuration
``configs/<config>.json`` and the traffic mix ``traffic/<traffic>.json``,
whose ``kind`` names its module, ``drivers/<kind>.py``. Per-layer metrics
are the readers in ``metrics/``, each a file of its own; a cell names the
end-to-end rate it reports (``rate``) and the per-layer metrics it reads
(``per_layer``).
"""

from __future__ import annotations

import functools
import glob
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# top-level module names the bench's process may not hold once its window
# has closed: JAX and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "biasgan_tpu")
# prefix of the bench's own profiler spans
SPAN = "bench."


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell ``name`` with its configuration and traffic mix attached
    (``cell['cfg']``, ``cell['mix']``)."""
    path = os.path.join(ROOT, "workloads", name + ".json")
    if not os.path.isfile(path):
        raise SystemExit(f"portbench: no cell {name!r} ({path})")
    cell = load_json(os.path.join("workloads", name + ".json"))
    cell["name"] = name
    cell["cfg"] = load_json(os.path.join("configs", cell["config"] + ".json"))
    cell["mix"] = load_json(os.path.join("traffic", cell["traffic"] + ".json"))
    return cell


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole
    (``biasgan_tpu_torch`` is not ``biasgan_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------


def make_params(specs: Dict[str, list], seed: int, device) -> Dict[str, Dict[str, "torch.Tensor"]]:
    """Every net's parameters from the seed, drawn on ``device`` in one
    call: conv weights and biases N(0, 0.02), batch-norm scales 1 + N(0,
    0.02). ``specs`` maps a net's name to its (name, shape, init) list."""
    import torch

    total = sum(math.prod(shape) for spec in specs.values() for _, shape, _ in spec)
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device) * 0.02
    out, off = {}, 0
    for net, spec in specs.items():
        out[net] = {}
        for name, shape, init in spec:
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            out[net][name] = t + 1.0 if init == "bn_weight" else t
            off += n
    return out


def load_into(module, params: Dict[str, "torch.Tensor"], net: str) -> None:
    """Copy ``params`` into ``module``'s parameters; the names and shapes
    must be the same on both sides."""
    import torch

    mine = dict(module.named_parameters())
    if set(mine) != set(params):
        raise RuntimeError(f"{net}: the program's parameters {sorted(set(mine) ^ set(params))} "
                           "differ from the reference's")
    with torch.no_grad():
        for name, p in mine.items():
            if tuple(p.shape) != tuple(params[name].shape):
                raise RuntimeError(f"{net}.{name}: shape {tuple(p.shape)} vs "
                                   f"{tuple(params[name].shape)}")
            p.copy_(params[name])


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def device_block(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


@dataclass
class Trace:
    """A traced window: the device operations (name, start, end) and the
    bench's host spans (name, start, end), in microseconds on one clock,
    the window's length in seconds and the units of work in it."""

    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    window_s: float
    units: int

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return sum(b - a for a, b in merged(self.ops)) / 1e6


def read_trace(prof, window_s: float, units: int) -> Trace:
    """The device operations and the bench's spans of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                ops.append((e.name, start, end))
        elif e.name.startswith(SPAN):
            spans.append((e.name, start, end))
    ops.sort(key=lambda o: o[1])
    return Trace(ops, spans, window_s, units)


def merged(ops) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, in order."""
    out: List[List[float]] = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def breakdown(trace: Trace, labelled: Trace, top: int = 10) -> dict:
    """The device operations of ``trace`` that took most time, summed by
    name, and the idle time between device operations of ``labelled``
    summed by the innermost bench span the host was in at the gap's middle
    (seconds)."""
    by_op: Dict[str, float] = {}
    for name, a, b in trace.ops:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    gaps: Dict[str, float] = {}
    busy = merged(labelled.ops)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) / 2
        inside = [s for s in labelled.spans if s[1] <= mid <= s[2]]
        label = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "outside bench spans"
        gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}


# ---------------------------------------------------------------------------
# per-layer metrics
# ---------------------------------------------------------------------------


@dataclass
class Reading:
    """What a per-layer metric's reader gets: the cell, its traced window
    and the counts the run took around it."""

    cell: dict
    trace: Trace
    launches: Dict[str, float] = field(default_factory=dict)
    extra: Dict[str, object] = field(default_factory=dict)

    @property
    def kind(self) -> str:
        return self.cell["mix"]["kind"]


def traced(cell, main, labelled, extra: dict) -> Reading:
    """The traced window: ``main()`` (-> units, seconds) under the profiler
    with device activity only, which adds little to the host's time, for
    the metrics and the device's busy and window seconds; then
    ``labelled()`` under host activity too, a short stretch whose bench
    spans say what the host was doing in each idle gap (the breakdown's
    ``idle_gaps``). The launch counts are the main window's, a unit."""
    from biasgan_tpu_torch.kernels import launch_counts
    from torch.profiler import ProfilerActivity, profile

    import torch

    before = launch_counts()
    device_only = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    with profile(activities=[device_only]) as prof:
        units, window = main()
    launches = {k: (v - before[k]) / units for k, v in launch_counts().items()}
    trace = read_trace(prof, window, units)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        units2, window2 = labelled()
    extra = dict(extra, labelled=read_trace(prof, window2, units2))
    return Reading(cell, trace, launches, extra)


def metric_readers() -> Dict[str, object]:
    """Every reader in ``metrics/``, by metric name (the file's name less
    ``.py``)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def reader_of(name: str, readers: Dict[str, object]):
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    the longest part of the name before a dot that has one, so that one
    quantity split by cell (``train.mfu.pix2pix``, ``train.mfu.cyclegan``)
    keeps one reader (``train.mfu``)."""
    parts = name.split(".")
    while parts:
        mod = readers.get(".".join(parts))
        if mod is not None:
            return mod
        parts.pop()
    raise SystemExit(f"portbench: no reader for metric {name!r} in metrics/")


def per_layer(reading: Reading) -> Dict[str, dict]:
    """Each of the cell's per-layer metrics (its ``per_layer`` list) whose
    reader finds something to read, with its unit."""
    readers, out = metric_readers(), {}
    for name in reading.cell["per_layer"]:
        mod = reader_of(name, readers)
        value = mod.read(reading)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


@functools.cache
def handwritten_names() -> frozenset:
    """The ``__global__`` functions of the program's CUDA sources."""
    import biasgan_tpu_torch.kernels as k

    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")
    names = set()
    for path in glob.glob(os.path.join(os.path.dirname(k.__file__), "csrc", "*.cu*")):
        with open(path) as f:
            names.update(pattern.findall(f.read()))
    return frozenset(names)


def kernel_function(kernel: str) -> str:
    """The unqualified function name of a demangled kernel name."""
    head = kernel.replace("(anonymous namespace)", "anon").split("(", 1)[0]
    depth, plain = 0, []
    for ch in head:
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and ch not in "<>":
            plain.append(ch)
    return "".join(plain).split("::")[-1].split(" ")[-1]


def is_handwritten(kernel: str) -> bool:
    """A device kernel of the port's own CUDA sources (and not a library's
    of the same function name, which sits in ``at::`` and the like)."""
    return (kernel_function(kernel) in handwritten_names()
            and not kernel.replace("void ", "").startswith(("at::", "cutlass", "cudnn")))


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap between two sets of per-leaf norms: |program -
    reference| over the larger of the reference's norm of that leaf and of
    the median leaf (of ``ref``)."""
    median = float(np.median(list(ref.values()))) if ref else 0.0
    return {k: abs(prog[k] - r) / max(r, median, 1e-30) for k, r in ref.items()}


def leaf_diffs(prog: Dict[str, "torch.Tensor"], ref: Dict[str, "torch.Tensor"],
               ref_norms: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's norm of the difference of two sets of tensors, over the
    larger of the reference's norm of that leaf and of the median leaf (of
    ``ref_norms``, whose leaves are those compared)."""
    import torch

    median = float(np.median(list(ref_norms.values()))) if ref_norms else 0.0
    out = {}
    for k, r in ref_norms.items():
        d = prog[k].to(ref[k].device, torch.float64) - ref[k].double()
        out[k] = float(d.norm()) / max(r, median, 1e-30)
    return out


def exact_f32() -> None:
    """The reference's precision: f32 products without TF32."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each number the cell compares (those ``limits`` names) beside its
    limit; correct where every one is finite and within it."""
    checks = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
