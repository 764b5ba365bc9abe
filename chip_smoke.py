#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (biasgan_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

It exits non-zero, printing no result, when CUDA is unavailable or the
checkout is missing, and at the first failure of any phase:

  1. environment: the card (nvidia-smi name and power limit), torch, CUDA,
     nvcc and Triton versions;
  2. build every kernel of the served and trained paths from csrc/ (nvcc,
     sm_90a), one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card (TF32 off):
     at the shapes its main path gives it (the full-globe serve, or for
     the VALID 3x3 conv the 256x256 CycleGAN step), in bf16 and f32, and
     over a sweep of small odd shapes, pad modes, prologues, activations
     and residuals, with the moments held to those of the stored output;
     then, at those shapes in bf16, the kernel's time beside the plain
     version's, one PyTorch library call's, and the card's bound for the
     same work;
  3b. the gradient phase: each differentiable kernel (the fused block conv
     of training, the VALID 3x3 op, the 7x7 conv, the fused instance norm)
     under autograd against autograd through its plain version on the
     card, f32 and bf16, with the JAX tests' bounds; then, at the training
     shapes in bf16, each one's forward and backward times beside
     cuDNN's through autograd;
  4. a small-input reference: the generator's kernel paths on the card
     against its plain path on the CPU (which the CPU tests hold to the JAX
     package), f32;
  5. a NetCDF-3 store of three 721x1440 fields per side and a seeded
     resnet_9blocks (ngf 64) checkpoint;
  6. serve the fields through ``biasgan_tpu_torch.infer.main`` on four
     paths, counting each kernel's launches: --fused_blocks; the plain
     path; --fused_blocks --fused_updown --conv7_pallas 1; and
     --force_pallas_norm. Outputs must be finite, of the right shape, and
     each kernel path must agree with the plain path;
  7. train full-width CycleGAN (resnet_9blocks ngf 64, basic D ndf 64,
     instance norm, lsgan, pool 50, 256x256, batch 1, 3 channels,
     synthetic data from a seed) in f32 and bf16 on four routes: plain;
     --fused_blocks; --pallas_conv 1; and --fused_blocks --conv7_pallas 1
     --force_pallas_norm. Each route's first step, from the same state and
     batch, is held to the plain route's (losses and step-1 gradients) with
     exact kernel launch counts; then ``biasgan_tpu_torch.train.main`` runs
     six steps on the route, counting launches, with finite losses, and
     its samples/s over steps 2-6 is printed. The checkpoint of one run is
     loaded by the inference CLI's loader.

Before its last line it prints one JSON object with the kernels' names,
sources, launch counts on their main path, errors, times and bounds. The
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GLOBE_H, GLOBE_W, N_VARS, N_TIMES = 721, 1440, 3, 3
PAD_MODES = ("zero", "reflect", "wrap")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # |y - ref| <= tol * (1 + |ref|)
MOMENT_TOL = 1e-3  # relative, see moment_error
MOMENT_SLACK = 1e-5  # f32 summation order, see stored_moment_ratio
# the card's published peaks (H100 SXM, dense, at 700 W), for the bounds:
# bf16 on the tensor cores, f32 outside them, device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# kernel -> (the TPU kernel it replaces, the main path it carries: a served
# path, or for the VALID 3x3 conv a training route)
KERNELS = {
    "conv3x3_fused": ("biasgan_tpu/ops/pallas_conv.py:771", "fused"),
    "conv3x3s2_fused": ("biasgan_tpu/ops/pallas_conv.py:1663", "fused_all"),
    "convt3x3s2_fused": ("biasgan_tpu/ops/pallas_conv.py:1318", "fused_all"),
    "conv7x7": ("biasgan_tpu/ops/pallas_conv7.py:197", "fused_all"),
    "instance_norm_act": ("biasgan_tpu/ops/pallas_fused.py:149", "plain_norm"),
    "conv3x3_valid": ("biasgan_tpu/ops/pallas_conv.py:279", "pallas_conv"),
}
# served path -> (infer flags, kernel launches per field)
PATHS = {
    "fused": (["--fused_blocks"], {"conv3x3_fused": 18}),
    "plain": ([], {}),
    "fused_all": (
        ["--fused_blocks", "--fused_updown", "--conv7_pallas", "1"],
        {"conv3x3_fused": 18, "conv3x3s2_fused": 2, "convt3x3s2_fused": 2, "conv7x7": 2},
    ),
    "plain_norm": (["--force_pallas_norm"], {"instance_norm_act": 23}),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def kernel_fns(name: str):
    """(wrapper, plain version) of kernel ``name``."""
    import importlib

    mod = importlib.import_module(f"biasgan_tpu_torch.kernels.{name}")
    return getattr(mod, name), getattr(mod, name + "_plain")


def environment(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    from biasgan_tpu_torch.kernels import build

    nvcc = subprocess.run(
        [build.find_nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout
    nvcc = next((ln for ln in nvcc.splitlines() if "release" in ln), nvcc.strip())
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    print(
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}, nvcc: {nvcc}, triton {triton_version}"
    )
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")


def build_kernels() -> None:
    """One nvcc per source, all at once; prints each kernel function's
    registers and spills from ptxas."""
    from biasgan_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    print(f"build {len(paths)} kernels: {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        build.load(name)
        with open(path + ".log") as f:
            log = f.read()
        fns = re.findall(r"Compiling entry function '(\S+)'", log)
        used = re.findall(r"Used (\d+) registers.*", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"  {name} -> {os.path.basename(path)}")
        for fn, u, sp in zip(fns, used, spills):
            short = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}", "", fn)[:70]
            print(f"    {short}: {u} registers, {sp} bytes spilled")


def moment_error(got, ref, count: int) -> float:
    """Largest relative moment error: the sum against sqrt(count * sumsq)
    (a bound on |sum| that stays away from zero when the mean is near 0),
    the sum of squares against itself."""
    (s, q), (rs, rq) = got, ref
    scale = (count * rq).sqrt().clamp_min(1e-30)
    return max(
        float(((s - rs).abs() / scale).max()),
        float(((q - rq).abs() / rq.clamp_min(1e-30)).max()),
    )


def stored_moment_ratio(y, m, ry, rm) -> float:
    """Moments of the stored value (the Pallas kernels' rule,
    pallas_conv.py:763-768): the kernel's moments may differ from the
    reference's by no more than its stored outputs do, plus f32 summation
    order (MOMENT_SLACK). Returns the largest |d moment| / that bound; moments
    of the value before the bf16 cast exceed it at small H*W."""
    (s, q), (rs, rq) = m, rm
    yf, rf = y.float(), ry.float()
    dims = (1, 2)
    sum_bound = (yf - rf).abs().sum(dims) + MOMENT_SLACK * rf.abs().sum(dims)
    sq_bound = (yf.square() - rf.square()).abs().sum(dims) + MOMENT_SLACK * rf.square().sum(dims)
    return max(
        float(((s - rs).abs() / sum_bound.clamp_min(1e-30)).max()),
        float(((q - rq).abs() / sq_bound.clamp_min(1e-30)).max()),
    )


# ---------------------------------------------------------------------------
# Kernel cases: the arguments of one call, its work and its library yardstick
# ---------------------------------------------------------------------------


def _randn(torch, g, shape, scale=1.0, shift=0.0):
    return scale * torch.randn(shape, generator=g, device="cuda") + shift


def _prologue(torch, g, n, c):
    return (0.5 + torch.rand((n, c), generator=g, device="cuda"),
            _randn(torch, g, (n, c), 0.5))


def make_case(torch, g, name, shape, dtype, **opt):
    """The wrapper's arguments for one call of kernel ``name`` on random
    inputs; for the bound, the bytes it must move and the seconds its
    operations take at the card's peak for their type; and one PyTorch call
    computing the same function (the library yardstick, timed only)."""
    import torch.nn.functional as F

    es = torch.finfo(dtype).bits // 8
    pro = opt.get("prologue", False)
    if name in ("conv3x3_fused", "conv3x3s2_fused", "convt3x3s2_fused"):
        n, h, w, c, cout = shape
        x = _randn(torch, g, (n, h, w, c)).to(dtype)
        wt = _randn(torch, g, (cout, c, 3, 3), (9 * c) ** -0.5).to(dtype)
        bias = _randn(torch, g, (cout,), 0.1)
        p = _prologue(torch, g, n, c) if pro else None
        if name == "conv3x3_fused":
            args = (x, wt, bias, p, "relu", opt.get("h_mode", "reflect"),
                    opt.get("w_mode", "wrap"), True)
            out_px = n * h * w
            lib = lambda: F.conv2d(x.permute(0, 3, 1, 2), wt, bias.to(dtype), padding=1)
        elif name == "conv3x3s2_fused":
            args = (x, wt, bias, p, "relu", opt.get("w_mode", "wrap"), True)
            out_px = n * h * w // 4
            lib = lambda: F.conv2d(x.permute(0, 3, 1, 2), wt, bias.to(dtype), stride=2,
                                   padding=1)
        else:
            wt = wt.transpose(0, 1).contiguous()  # IOHW
            args = (x, wt, bias, p, "relu", opt.get("w_mode", "wrap"), True)
            out_px = 4 * n * h * w
            lib = lambda: F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, bias.to(dtype),
                                             stride=2, padding=1, output_padding=1)
        flops = 2 * (n * h * w if name != "conv3x3s2_fused" else out_px) * 9 * c * cout
        nbytes = ((n * h * w * c + out_px * cout + 9 * c * cout) * es + 4 * cout
                  + (8 * n * c if pro else 0) + 8 * n * cout)
    elif name == "conv3x3_valid":
        n, hp, wp, c, cout = shape
        xp = _randn(torch, g, (n, hp, wp, c)).to(dtype)
        wt = _randn(torch, g, (cout, c, 3, 3), (9 * c) ** -0.5).to(dtype)
        bias = _randn(torch, g, (cout,), 0.1) if opt.get("bias") else None
        out_px = n * (hp - 2) * (wp - 2)
        res = opt.get("residual", False)
        r = _randn(torch, g, (n, hp - 2, wp - 2, cout)).to(dtype) if res else None
        args = (xp, wt, bias, r, opt.get("act", "none"))
        flops = 2 * out_px * 9 * c * cout
        nbytes = ((n * hp * wp * c + (1 + res) * out_px * cout + 9 * c * cout) * es
                  + (4 * cout if bias is not None else 0))
        lib = lambda: F.conv2d(xp.permute(0, 3, 1, 2), wt)
    elif name == "conv7x7":
        n, hp, wp, c, cout = shape
        xp = _randn(torch, g, (n, hp, wp, c)).to(dtype)
        wt = _randn(torch, g, (cout, c, 7, 7), (49 * c) ** -0.5).to(dtype)
        bias = _randn(torch, g, (cout,), 0.1)
        args = (xp, wt, bias)
        out_px = n * (hp - 6) * (wp - 6)
        flops = 2 * out_px * 49 * c * cout
        nbytes = (n * hp * wp * c + out_px * cout + 49 * c * cout) * es + 4 * cout
        lib = lambda: F.conv2d(xp.permute(0, 3, 1, 2), wt, bias.to(dtype))
    else:  # instance_norm_act
        act, res = opt.get("act", "relu"), opt.get("residual", False)
        x = _randn(torch, g, shape, 3.0, 1.0).to(dtype)
        r = _randn(torch, g, shape).to(dtype) if res else None
        args = (x, r, act)
        numel = x.numel()
        flops = (5 + res) * numel  # sum, square, subtract, scale, activation
        nbytes = (3 if res else 2) * numel * es
        act_fn = {"relu": F.relu, "lrelu": lambda t: F.leaky_relu(t, 0.2),
                  "none": lambda t: t}[act]

        def lib():
            z = F.instance_norm(x.permute(0, 3, 1, 2))
            return act_fn(z + r.permute(0, 3, 1, 2) if res else z)
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    if name == "instance_norm_act":
        peak = PEAK_FLOPS["float32"]  # reductions and elementwise: no tensor cores
    return args, nbytes, flops / peak, lib


def hold(torch, name, args, where: str):
    """The kernel against its plain version on the same inputs; returns
    max |dy| and, for kernels with moments, the stored-value moment ratio."""
    fn, plain = kernel_fns(name)
    got, ref = fn(*args), plain(*args)
    torch.cuda.synchronize()
    (y, m), (ry, rm) = (got, ref) if isinstance(got, tuple) else ((got, None), (ref, None))
    dtype = str(y.dtype).replace("torch.", "")
    yf, rf = y.float(), ry.float()
    err = float((yf - rf).abs().max())
    check(y.shape == ry.shape and y.dtype == ry.dtype, f"{name} {where}: shape or dtype")
    check(bool(torch.isfinite(yf).all()), f"{name} {where}: non-finite kernel output")
    check(bool(((yf - rf).abs() <= TOL[dtype] * (1 + rf.abs())).all()),
          f"{name} {where}: y off by {err:.3g}")
    if m is None:
        return err, 0.0
    merr = moment_error(m, rm, y.shape[1] * y.shape[2])
    check(merr <= MOMENT_TOL, f"{name} {where}: moments off by {merr:.3g} (relative)")
    ratio = stored_moment_ratio(y, m, ry, rm)
    check(ratio <= 1, f"{name} {where}: moments {ratio:.3g}x further off than the "
          "stored y allows")
    return err, ratio


# the globe shapes each kernel takes on its served path: (shape, options,
# calls per field)
GLOBE_CALLS = {
    "conv3x3_fused": [((1, 181, 360, 256, 256), dict(prologue=True), 18)],
    "conv3x3s2_fused": [((1, 724, 1440, 64, 128), dict(prologue=True), 1),
                        ((1, 362, 720, 128, 256), dict(prologue=True), 1)],
    "convt3x3s2_fused": [((1, 181, 360, 256, 128), dict(prologue=False), 1),
                         ((1, 362, 720, 128, 64), dict(prologue=True), 1)],
    "conv7x7": [((1, 730, 1446, 3, 64), {}, 1), ((1, 730, 1446, 64, 3), {}, 1)],
    "instance_norm_act": [((1, 724, 1440, 64), dict(act="relu"), 2),
                          ((1, 362, 720, 128), dict(act="relu"), 2),
                          ((1, 181, 360, 256), dict(act="relu"), 10),
                          ((1, 181, 360, 256), dict(act="none", residual=True), 9)],
    # the 256x256 CycleGAN step, batch 1: the 18 block convs of each of the
    # three batched G dispatches (2, 3 and 1 samples), forward and input
    # gradient (the cotangent padded by 2); calls per step
    "conv3x3_valid": [((b, 66, 66, 256, 256), {}, 18) for b in (2, 3, 1)]
    + [((b, 68, 68, 256, 256), dict(bwd=True), 18) for b in (2, 3, 1)],
}
# what each kernel's calls above are counted per
PER_UNIT = {name: "field" for name in GLOBE_CALLS}
PER_UNIT["conv3x3_valid"] = "step"
# shapes held besides the main path's: the globe block conv as a VALID conv
EXTRA_CHECKS = {"conv3x3_valid": [((1, 183, 362, 256, 256), dict(bias=True))]}


def sweep_cases(name):
    """Small odd shapes over the modes each kernel takes."""
    if name == "conv3x3_fused":
        i = 0
        for c, cout in ((3, 5), (32, 48), (256, 256)):
            for h_mode in PAD_MODES:
                for w_mode in PAD_MODES:
                    yield (2, 13, 37, c, cout), dict(prologue=i % 2 == 1, h_mode=h_mode,
                                                     w_mode=w_mode)
                    i += 1
    elif name in ("conv3x3s2_fused", "convt3x3s2_fused"):
        h, w = (26, 38) if name == "conv3x3s2_fused" else (13, 19)
        for c, cout in ((3, 5), (64, 128), (256, 64)):
            for w_mode in ("wrap", "zero"):
                for pro in (False, True):
                    yield (2, h, w, c, cout), dict(prologue=pro, w_mode=w_mode)
    elif name == "conv7x7":
        for c, cout in ((1, 5), (3, 64), (8, 16), (64, 3), (9, 8), (24, 1)):
            yield (2, 19, 41, c, cout), {}
    elif name == "conv3x3_valid":
        for c, cout in ((3, 5), (32, 48), (256, 256)):
            for act in ("none", "relu", "lrelu"):
                for bias, res in ((False, False), (True, False), (True, True), (False, True)):
                    yield (2, 15, 39, c, cout), dict(act=act, bias=bias, residual=res)
    else:
        for c in (5, 64, 264):
            for act in ("none", "relu", "lrelu"):
                for res in (False, True):
                    yield (2, 13, 37, c), dict(act=act, residual=res)


def check_kernels(torch) -> dict:
    """Every kernel against its plain version: its main path's shapes (and
    EXTRA_CHECKS) in bf16 and f32, then the sweep in both dtypes. Returns
    max |dy| at the main path's shapes in bf16, per kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for name in KERNELS:
        errs[name] = 0.0
        main_shapes = [(shape, opt) for shape, opt, _ in GLOBE_CALLS[name]]
        for shape, opt in main_shapes + EXTRA_CHECKS.get(name, []):
            for dtype in (torch.bfloat16, torch.float32):
                args = make_case(torch, g, name, shape, dtype, **opt)[0]
                where = f"main {shape} {dtype} {opt}"
                err, ratio = hold(torch, name, args, where)
                print(f"{name} {where}: max|dy| {err:.3g}"
                      + (f", moments at {ratio:.3g} of the stored-value bound" if ratio else ""))
                if dtype == torch.bfloat16:
                    errs[name] = max(errs[name], err)
        n_cases, worst = 0, 0.0
        for shape, opt in sweep_cases(name):
            for dtype in (torch.bfloat16, torch.float32):
                args = make_case(torch, g, name, shape, dtype, **opt)[0]
                worst = max(worst, hold(torch, name, args, f"{shape} {dtype} {opt}")[1])
                n_cases += 1
        print(f"{name} sweep: {n_cases} cases within tolerance"
              + (f"; moments at most {worst:.3g} of the stored-value bound" if worst else ""))
    return errs


def time_kernels(torch) -> dict:
    """At each globe shape in bf16: the kernel, its plain version and the
    library call, in turns (plain, library, kernel, kernel, library,
    plain), CUDA events over 20 calls each after 3 warm-up calls, best of
    each; and the bound. Per kernel, the per-field sums (each shape's time
    times its calls per field) and the per-shape numbers."""
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name in KERNELS:
        fn, plain = kernel_fns(name)
        calls = []
        for shape, opt, count in GLOBE_CALLS[name]:
            args, nbytes, op_s, lib = make_case(torch, g, name, shape, torch.bfloat16, **opt)
            fns = {"plain": lambda: plain(*args), "library": lib, "kernel": lambda: fn(*args)}
            runs = {k: [] for k in fns}
            for which in ("plain", "library", "kernel", "kernel", "library", "plain"):
                runs[which].append(timed(torch, fns[which]))
            best = {k: min(v) for k, v in runs.items()}
            byte_ms, op_ms = nbytes / PEAK_BYTES * 1e3, op_s * 1e3
            calls.append({
                "shape": list(shape), "options": opt, "count": count,
                "ms": best["kernel"], "plain_ms": best["plain"],
                "library_ms": best["library"], "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "bytes_ms": byte_ms, "operations_ms": op_ms,
            })
            print(f"{name} {shape} bf16 {opt}, ms per call (in turns): "
                  + "; ".join(f"{k} {v}" for k, v in runs.items())
                  + f"; bound {max(byte_ms, op_ms):.4f} ms ({calls[-1]['bound_by']})")
        fwd = [c for c in calls if not c["options"].get("bwd")]
        total = {k: sum(c[k] * c["count"] for c in fwd)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                           "operations_ms")}
        total["bound_by"] = "bytes" if total["bytes_ms"] >= total["operations_ms"] else "operations"
        bwd = [c for c in calls if c["options"].get("bwd")]
        if bwd:  # the VALID conv's input-gradient launches
            total["bwd_kernel_ms"] = sum(c["ms"] * c["count"] for c in bwd)
        total["calls"] = calls
        out[name] = total
    return out


def timed(torch, fn, iters=20, warmup=3):
    """ms per call of ``fn``: CUDA events over ``iters`` calls after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# The gradient phase: the differentiable kernels under autograd
# ---------------------------------------------------------------------------

def _in_norms(b_g, b_d):
    """The instance norms of the all-kernel route per step: the five
    non-block norms of each G dispatch (batch b_g) and the three of each D
    forward (batch b_d), as (shape, act, count)."""
    out = []
    for b in b_g:
        out += [((b, 256, 256, 64), "relu", 2), ((b, 128, 128, 128), "relu", 2),
                ((b, 64, 64, 256), "relu", 1)]
    for b, n in b_d:
        out += [((b, 64, 64, 128), "lrelu", n), ((b, 32, 32, 256), "lrelu", n),
                ((b, 31, 31, 512), "lrelu", n)]
    return out


# differentiable form -> (kernel, its calls per 256x256 CycleGAN step at
# batch 1 on the route that runs it: (make_case shape, options, count))
GRAD_CALLS = {
    "conv3x3_fused_t": ("conv3x3_fused", [((b, 64, 64, 256, 256), dict(prologue=True), 18)
                                          for b in (2, 3, 1)]),
    "conv3x3_op": ("conv3x3_valid", [((b, 66, 66, 256, 256), {}, 18) for b in (2, 3, 1)]),
    "conv7x7": ("conv7x7", [((b, 262, 262, 3, 64), {}, 1) for b in (2, 3, 1)]
                + [((b, 262, 262, 64, 3), {}, 1) for b in (2, 3, 1)]),
    "instance_norm_act": ("instance_norm_act", [
        (shape, dict(act=act), n) for shape, act, n in _in_norms((2, 3, 1), ((1, 2), (2, 2)))]),
}
# the shapes whose gradients are held to autograd through the plain version
GRAD_CHECKS = {
    "conv3x3_fused_t": [((2, 64, 64, 256, 256), dict(prologue=True)),
                        ((1, 64, 64, 256, 256), dict(prologue=False))],
    "conv3x3_op": [((2, 66, 66, 256, 256), {}), ((1, 15, 39, 32, 48), dict(bias=True))],
    "conv7x7": [((1, 262, 262, 3, 64), {}), ((1, 262, 262, 64, 3), {})],
    "instance_norm_act": [((2, 64, 64, 256), dict(act="none", residual=True)),
                          ((1, 256, 256, 64), dict(act="relu")),
                          ((2, 31, 31, 512), dict(act="lrelu"))],
}
GRAD_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (0.05, 0.1)}  # (atol x max(1,|ref|), rtol)


def grad_case(torch, g, form, shape, dtype, **opt):
    """(differentiable call, plain call, library call, inputs that require
    grad, nbytes, op_s) for one call of ``form``: each call maps the inputs
    to its outputs (a list)."""
    import torch.nn.functional as F

    from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused_plain, conv3x3_fused_t
    from biasgan_tpu_torch.kernels.conv3x3_valid import conv3x3_op, conv3x3_valid_plain
    from biasgan_tpu_torch.kernels.conv7x7 import conv7x7, conv7x7_plain
    from biasgan_tpu_torch.kernels.instance_norm_act import (
        instance_norm_act,
        instance_norm_act_plain,
    )

    kernel = GRAD_CALLS[form][0]
    args, nbytes, op_s, _ = make_case(torch, g, kernel, shape, dtype, **opt)
    leaves = [t.detach().requires_grad_(True) if isinstance(t, torch.Tensor) else t
              for t in args]
    ins = [t for t in leaves if isinstance(t, torch.Tensor)]
    if form == "conv3x3_fused_t":
        x, w, bias, pro, act, hm, wm, _ = leaves
        pro = tuple(t.detach().requires_grad_(True) for t in pro) if pro else None
        ins = [x, w, bias] + list(pro or ())

        def flat(out):
            y, (s, q) = out
            return [y, s, q]

        fn = lambda: flat(conv3x3_fused_t(x, w, bias, pro, act, hm, wm))
        plain = lambda: flat(conv3x3_fused_plain(x, w, bias, pro, act, hm, wm))
        lib = lambda: [F.conv2d(x.permute(0, 3, 1, 2), w, bias.to(dtype), padding=1)]
    elif form == "conv3x3_op":
        xp, w, bias = leaves[:3]
        fn = lambda: [conv3x3_op(xp, w, bias)]
        plain = lambda: [conv3x3_valid_plain(xp, w, bias)]
        lib = lambda: [F.conv2d(xp.permute(0, 3, 1, 2), w)]
    elif form == "conv7x7":
        xp, w, bias = leaves
        fn = lambda: [conv7x7(xp, w, bias)]
        plain = lambda: [conv7x7_plain(xp, w, bias)]
        lib = lambda: [F.conv2d(xp.permute(0, 3, 1, 2), w, bias.to(dtype))]
    else:
        x, r, act = leaves
        fn = lambda: [instance_norm_act(x, r, act)]
        plain = lambda: [instance_norm_act_plain(x, r, act)]
        act_fn = {"relu": F.relu, "lrelu": lambda t: F.leaky_relu(t, 0.2),
                  "none": lambda t: t}[act]

        def lib():
            z = F.instance_norm(x.permute(0, 3, 1, 2))
            return [act_fn(z + r.permute(0, 3, 1, 2) if r is not None else z)]
    return fn, plain, lib, ins, nbytes, op_s


def check_grads(torch) -> dict:
    """Each differentiable form's gradients of a random cotangent (every
    output: y and, for the fused conv, both moments) against autograd
    through its plain version, f32 and bf16. Returns the largest |d grad|
    relative to max(1, |ref|) per form, bf16."""
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = {}
    for form, cases in GRAD_CHECKS.items():
        worst[form] = 0.0
        for shape, opt in cases:
            for dtype in (torch.bfloat16, torch.float32):
                fn, plain, _, ins, _, _ = grad_case(torch, g, form, shape, dtype, **opt)
                outs = fn()
                check(all(o.grad_fn is not None for o in outs), f"{form}: no grad_fn")
                cots = [torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
                        for o in outs]
                got = torch.autograd.grad(outs, ins, cots)
                ref = torch.autograd.grad(plain(), ins, cots)
                atol, rtol = GRAD_TOL[str(dtype).replace("torch.", "")]
                errs = []
                for i, (a, b) in enumerate(zip(got, ref)):
                    a, b = a.float(), b.float()
                    scale = max(1.0, float(b.abs().max()))
                    check(bool(torch.isfinite(a).all()), f"{form} {shape}: non-finite grad {i}")
                    ok = bool(((a - b).abs() <= atol * scale + rtol * b.abs()).all())
                    errs.append(float((a - b).abs().max()) / scale)
                    check(ok, f"{form} {shape} {dtype} {opt}: grad {i} off by {errs[-1]:.3g} "
                          "of max(1, |ref|)")
                print(f"{form} {shape} {dtype} {opt}: grads within bounds, largest |d| "
                      f"{max(errs):.3g} of max(1, |ref|)")
                if dtype == torch.bfloat16:
                    worst[form] = max(worst[form], max(errs))
    return worst


def time_grads(torch) -> dict:
    """At each training shape in bf16: the differentiable form's forward
    (autograd recording) and backward, beside cuDNN's (or the library
    norm's) through autograd, in turns, CUDA events, best of two; the
    plain version's forward; the forward bound. Per form, the per-step sums
    (each call's time times its count) and the per-call numbers."""
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for form, (_, calls) in GRAD_CALLS.items():
        rows = []
        for shape, opt, count in calls:
            fn, plain, lib, ins, nbytes, op_s = grad_case(torch, g, form, shape,
                                                          torch.bfloat16, **opt)
            runs = {k: [] for k in ("fwd", "bwd", "library_fwd", "library_bwd")}
            for which, f in (("", fn), ("library_", lib), ("library_", lib), ("", fn)):
                outs = f()
                cots = [torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
                        for o in outs]
                runs[which + "fwd"].append(timed(torch, f, iters=10, warmup=2))
                runs[which + "bwd"].append(timed(
                    torch, lambda: torch.autograd.grad(outs, ins, cots, retain_graph=True,
                                                       allow_unused=True),
                    iters=10, warmup=2))
                del outs
            with torch.no_grad():
                plain_ms = timed(torch, plain, iters=5, warmup=1)
            best = {k: min(v) for k, v in runs.items()}
            byte_ms, op_ms = nbytes / PEAK_BYTES * 1e3, op_s * 1e3
            rows.append({"shape": list(shape), "options": opt, "count": count,
                         "ms": best["fwd"], "bwd_ms": best["bwd"], "plain_ms": plain_ms,
                         "library_ms": best["library_fwd"],
                         "library_bwd_ms": best["library_bwd"],
                         "bound_ms": max(byte_ms, op_ms), "bytes_ms": byte_ms,
                         "operations_ms": op_ms})
            print(f"{form} {shape} bf16 {opt} x{count}/step, ms per call (in turns): "
                  + "; ".join(f"{k} {v}" for k, v in runs.items())
                  + f"; plain fwd {plain_ms:.4f}; fwd bound {max(byte_ms, op_ms):.4f}")
        total = {k: sum(r[k] * r["count"] for r in rows)
                 for k in ("ms", "bwd_ms", "plain_ms", "library_ms", "library_bwd_ms",
                           "bound_ms", "bytes_ms", "operations_ms")}
        total["bound_by"] = "bytes" if total["bytes_ms"] >= total["operations_ms"] else "operations"
        total["calls"] = rows
        out[form] = total
    return out


def check_small_generator(torch) -> None:
    """The generator's kernel paths on the card against its plain path on
    the CPU, f32, tiny shape (H divisible by 4, so the fused down path
    engages)."""
    from biasgan_tpu_torch.nn import define_G

    g = torch.Generator().manual_seed(2)
    G = define_G(
        "resnet_2blocks", 3, 3, ngf=16, norm="instance", w_mode="wrap",
        out_activation="none", generator=g,
    ).eval()
    x = torch.randn((1, 16, 40, 3), generator=g)
    with torch.inference_mode():
        ref = G(x)
        Gc = G.to("cuda")
        for path, routes in (("fused", dict(fused_blocks=True)),
                             ("fused_all", dict(fused_blocks=True, fused_updown=True,
                                                conv7=True)),
                             ("plain_norm", dict(fused_norm=True))):
            for attr in ("fused_blocks", "fused_updown", "conv7", "fused_norm"):
                setattr(Gc, attr, routes.get(attr, False))
            got = Gc(x.to("cuda")).cpu()
            err = float((got - ref).abs().max())
            print(f"resnet_2blocks (1,16,40,3) f32 {path}: card kernel path vs CPU plain "
                  f"max|dy| {err:.3g}")
            check(err <= 2e-4 * (1 + float(ref.abs().max())),
                  f"small generator, {path} path, off by {err:.3g}")


def make_store(root: str) -> None:
    """testA/ and testB/: one NetCDF-3 file each, N_VARS variables of
    (N_TIMES, 721, 1440) smooth fields; B is the synthetic 'model bias' of
    A."""
    import numpy as np
    from scipy.io import netcdf_file

    from biasgan_tpu_torch.data.synthetic import bias_transform, smooth_field

    rng = np.random.default_rng(0)
    a = np.stack([
        np.stack([smooth_field(rng, GLOBE_H, GLOBE_W, 2.0) for _ in range(N_TIMES)])
        for _ in range(N_VARS)
    ])
    for side, data in (("A", a), ("B", bias_transform(a))):
        d = os.path.join(root, "test" + side)
        os.makedirs(d, exist_ok=True)
        with netcdf_file(os.path.join(d, "fields.nc"), "w") as f:
            f.createDimension("time", N_TIMES)
            f.createDimension("lat", GLOBE_H)
            f.createDimension("lon", GLOBE_W)
            for v in range(N_VARS):
                var = f.createVariable(f"var{v}", "f4", ("time", "lat", "lon"))
                var[:] = data[v]


def serve(torch, work: str, path: str):
    """One infer.main run over the store on ``path``; returns (fields,
    per-field ms, per-field Mpx/s, kernel launches). Every kernel's count
    is set to 0 just before the run and read just after it."""
    import numpy as np

    from biasgan_tpu_torch import infer

    fns = {name: kernel_fns(name)[0] for name in KERNELS}
    argv = [
        "--model", "pix2pix", "--dataset_mode", "climate",
        "--dataroot", os.path.join(work, "data"),
        "--checkpoints_dir", os.path.join(work, "ckpt"), "--name", "globe",
        "--results_dir", os.path.join(work, "results_" + path),
        "--full_field", "--compute_dtype", "bfloat16",
        "--netG", "resnet_9blocks", "--ngf", "64", "--norm", "instance",
        "--no_dropout", "--w_pad_mode", "wrap", "--netG_activation", "none",
        "--input_nc", str(N_VARS), "--output_nc", str(N_VARS),
        "--num_test", str(N_TIMES), "--device", "cuda",
    ] + PATHS[path][0]
    out = io.StringIO()
    for fn in fns.values():
        fn.launches = 0
    with contextlib.redirect_stdout(out):
        out_dir = infer.main(argv)
    launches = {name: fn.launches for name, fn in fns.items()}
    log = out.getvalue()
    lines = [ln for ln in log.splitlines() if ln.startswith(("[", "--"))]
    print("\n".join(f"  {path}: {ln}" for ln in lines))
    stamps = re.findall(r"corrected in ([0-9.]+) ms \(([0-9.]+) Mpx/s\)", log)
    check(len(stamps) == N_TIMES, f"{path}: expected {N_TIMES} served fields, got {len(stamps)}")
    fields = []
    for i in range(N_TIMES):
        y = np.load(os.path.join(out_dir, f"corrected_{i:05d}.npy"))
        check(y.shape == (1, GLOBE_H, GLOBE_W, N_VARS), f"{path}: field {i} shape {y.shape}")
        check(bool(np.isfinite(y).all()), f"{path}: field {i} has non-finite values")
        fields.append(y)
    want = {name: PATHS[path][1].get(name, 0) * N_TIMES for name in KERNELS}
    check(launches == want, f"{path}: kernel launches {launches}, expected {want} "
          f"({N_TIMES} fields)")
    return fields, [float(s[0]) for s in stamps], [float(s[1]) for s in stamps], launches


def serve_globe(torch, work: str) -> dict:
    """Serve every path; hold each kernel path to the plain one. Returns
    each path's kernel launches."""
    import numpy as np

    from biasgan_tpu_torch.data import stats
    from biasgan_tpu_torch.nn import define_G
    from biasgan_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    make_store(os.path.join(work, "data"))
    g = torch.Generator().manual_seed(0)
    G = define_G(
        "resnet_9blocks", N_VARS, N_VARS, ngf=64, norm="instance",
        w_mode="wrap", out_activation="none", generator=g,
    )
    checkpoint.save_network(G, os.path.join(work, "ckpt", "globe"), "latest", "G")
    print(f"store + checkpoint: {time.perf_counter() - t0:.1f} s")

    served = {path: serve(torch, work, path) for path in PATHS}
    # field 0 of each kernel path against the plain path: bf16 rounds at
    # different places on the two, so hold them to the repo's own bf16
    # globe rule (tests/integration/test_infer_globe.py:107: rtol 2e-2,
    # atol 1 K at a std of ~10 K, i.e. |dy| <= 0.02 |y| + 0.1 std of the
    # target variable), and the mean |dy| to 0.01 std
    sd = stats.load_or_compute_stats(
        os.path.join(work, "data", "stats_B.json"), [], [f"var{v}" for v in range(N_VARS)]
    )
    std = np.array([sd[f"var{v}"]["std"] for v in range(N_VARS)], np.float32)
    plain = served["plain"][0][0]
    for path in PATHS:
        if path == "plain":
            continue
        diff = np.abs(served[path][0][0] - plain)
        excess = diff - (0.02 * np.abs(plain) + 0.1 * std)
        print(
            f"field 0, {path} vs plain path: max |dy| {float((diff / std).max()):.4g} std, "
            f"mean |dy| {float((diff / std).mean()):.4g} std, "
            f"worst margin to the bf16 bound {float(excess.max()):.4g}"
        )
        check(float(excess.max()) <= 0 and float((diff / std).mean()) <= 0.01,
              f"{path} and plain globe outputs disagree beyond bf16 tolerance")
    name = torch.cuda.get_device_name(0)
    for path, (_, ms, mpx, _) in served.items():
        print(
            f"globe {GLOBE_H}x{GLOBE_W}x{N_VARS} bf16 {path}: ms/field {ms} "
            f"(field 0 warms up; median of the rest {statistics.median(ms[1:]):.1f}), "
            f"Mpx/s {mpx} on {name}"
        )
    return {path: s[3] for path, s in served.items()}


# ---------------------------------------------------------------------------
# Training: full-width CycleGAN on four kernel routes
# ---------------------------------------------------------------------------

TRAIN_SAMPLES = 6  # one epoch of six steps at batch 1
# a route's step-1 gradients may be, per net, at most NOISE_FACTOR times as
# far from plain's (relative L2) as plain's own are from a rerun on inputs
# moved by NOISE_INPUT (relative: a few f32 ulps, one bf16 ulp), plus
# NET_GRAD_TOL (see hold_first_step)
NOISE_FACTOR = 3.0
NOISE_INPUT = {"float32": 1e-6, "bfloat16": 2.0**-8}
NET_GRAD_TOL = {"float32": 1e-3, "bfloat16": 0.05}
TRAIN_ARGS = [
    "--model", "cycle_gan", "--dataset_mode", "synthetic", "--seed", "0",
    "--netG", "resnet_9blocks", "--ngf", "64", "--netD", "basic", "--ndf", "64",
    "--norm", "instance", "--no_dropout", "--gan_mode", "lsgan", "--pool_size", "50",
    "--lambda_A", "10", "--lambda_B", "10", "--lambda_identity", "0.5",
    "--lr", "2e-4", "--beta1", "0.5", "--lr_policy", "linear",
    "--crop_size", "256", "--batch_size", "1", "--input_nc", "3", "--output_nc", "3",
    "--synthetic_samples", str(TRAIN_SAMPLES), "--n_epochs", "1", "--n_epochs_decay", "0",
    "--print_freq", "1", "--save_latest_freq", "1000000", "--device", "cuda",
]
# training route -> (train flags, launches per step: each kernel's, the
# differentiable fused conv's, and the VALID conv's input-gradient ones).
# Per step: 3 G dispatches x 18 block convs; 3 x (stem + head); the
# all-kernel route's norms: 3 x 5 in the Gs, 4 D forwards x 3 in the Ds.
TRAIN_ROUTES = {
    "plain": ([], {}),
    "fused": (["--fused_blocks"], {"conv3x3_fused": 54, "conv3x3_fused_t": 54}),
    "pallas_conv": (["--pallas_conv", "1"], {"conv3x3_valid": 54, "conv3x3_valid.bwd": 54}),
    "all": (["--fused_blocks", "--conv7_pallas", "1", "--force_pallas_norm"],
            {"conv3x3_fused": 54, "conv3x3_fused_t": 54, "conv7x7": 6,
             "instance_norm_act": 27}),
}


def _counters():
    """Every launch count: name -> (function object, attribute)."""
    from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused_t

    c = {name: (kernel_fns(name)[0], "launches") for name in KERNELS}
    c["conv3x3_fused_t"] = (conv3x3_fused_t, "launches")
    c["conv3x3_valid.bwd"] = (kernel_fns("conv3x3_valid")[0], "bwd_launches")
    return c


def zero_counts() -> None:
    for obj, attr in _counters().values():
        setattr(obj, attr, 0)


def read_counts() -> dict:
    return {k: getattr(obj, attr) for k, (obj, attr) in _counters().items()}


def train_argv(route, dtype, work, name, save=False):
    return TRAIN_ARGS + TRAIN_ROUTES[route][0] + [
        "--compute_dtype", dtype, "--checkpoints_dir", os.path.join(work, "train"),
        "--name", name, "--save_epoch_freq", "1" if save else "100",
    ]


def _by_net_max(grads):
    """net -> the largest |grad| over its parameters."""
    out = {}
    for k, v in grads.items():
        net = k.split(".", 1)[0]
        out[net] = max(out.get(net, 0.0), float(v.float().abs().max()))
    return out


def train_steps(torch, route, dtype, work, perturb=0.0, timed_steps=True) -> dict:
    """Step 1 from the seeded state on the first batch (its A and B moved
    by ``perturb`` relative noise, for the noise floor), with the step's
    gradients and exact launch counts; then 5 more steps, timed (host
    clock, synchronized), with finite losses."""
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.data import create_dataset
    from biasgan_tpu_torch.models.common import step_generator
    from biasgan_tpu_torch.models.cyclegan import create_state, make_train_step
    from biasgan_tpu_torch.train import batch_to

    cfg = parse_config(train_argv(route, dtype, work, f"steps_{route}_{dtype}"), train=True)
    cfg.steps_per_epoch = TRAIN_SAMPLES
    dev = torch.device(cfg.device)
    batches = [batch_to(d, dev) for d in create_dataset(cfg)]
    if perturb:
        g = torch.Generator(device=dev).manual_seed(11)
        for k in ("A", "B"):
            x = batches[0][k]
            batches[0][k] = x * (1 + perturb * torch.randn(x.shape, generator=g, device=dev))
    state = create_state(cfg, dev)
    step = make_train_step(cfg, debug_grads=True)
    zero_counts()
    losses, vis = step(state, batches[0], step_generator(cfg.seed, 0))
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: TRAIN_ROUTES[route][1].get(k, 0) for k in counts}
    check(counts == want, f"train {route} {dtype} step 1: launches {counts}, expected {want}")
    first = {"losses": {k: float(v) for k, v in losses.items()},
             "G": vis["_g_grads"], "D": vis["_d_grads"]}
    if not timed_steps:
        return first
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    later = []
    for i, batch in enumerate(batches[1:], start=1):
        later.append(step(state, batch, step_generator(cfg.seed, i))[0])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    vals = [float(v) for ls in later for v in ls.values()]
    check(all(v == v and abs(v) < float("inf") for v in vals) and all(
        v == v for v in first["losses"].values()), f"train {route} {dtype}: non-finite loss")
    first["samples_per_s"] = len(later) * cfg.batch_size / dt
    first["ms_per_step"] = dt / len(later) * 1e3
    del state
    return first


def grad_distance(got, ref):
    """(the largest elementwise |d grad| relative to max(1, the net's
    largest |grad|), the relative L2 distance per net) of two steps'
    gradients."""
    worst, rel = 0.0, {}
    for which in ("G", "D"):
        scale = _by_net_max(ref[which])
        diff2, ref2 = {}, {}
        for name, r in ref[which].items():
            a, b = got[which][name].float(), r.float()
            net = name.split(".", 1)[0]
            worst = max(worst, float((a - b).abs().max()) / max(1.0, scale[net]))
            diff2[net] = diff2.get(net, 0.0) + float((a - b).square().sum())
            ref2[net] = ref2.get(net, 0.0) + float(b.square().sum())
        for net in diff2:
            rel[net] = (diff2[net] / max(ref2[net], 1e-30)) ** 0.5
    return worst, rel


def hold_first_step(route, dtype, got, ref, floor) -> dict:
    """A route's first step against the plain route's: losses (f32 rtol
    2e-4, bf16 the repo's 2e-2), and each net's gradients within
    NOISE_FACTOR x ``floor`` + NET_GRAD_TOL of plain's in relative L2,
    where ``floor`` is how far plain's own move when its inputs move by a
    few ulps. The elementwise bound of the gradient phase holds for one
    kernel but not through the networks at initialization: the routes sum
    in other orders (cuDNN's f32 algorithms, the kernels' exact f32
    accumulation, bf16 casts in other places), and the Ds' instance norms
    and the 7x7 stem's weight gradient (a sum over 65,536 pixels with heavy
    cancellation) magnify that. The first chip run read f32 relative L2s of
    3.0e-3 to 4.3e-3 for the Gs (the elementwise bound failed at 5.37e-3 of
    the net's largest |grad| at the stem) and bf16 0.20 to 0.23, with every
    loss within its bound."""
    fails = []
    rtol_loss = 2e-4 if dtype == "float32" else 2e-2
    for k, v in ref["losses"].items():
        if abs(got["losses"][k] - v) > rtol_loss * abs(v) + 1e-6:
            fails.append(f"train {route} {dtype} step 1: loss {k} {got['losses'][k]} vs "
                         f"plain {v}")
    worst, rel = grad_distance(got, ref)
    for net, d in rel.items():
        bound = NOISE_FACTOR * floor[net] + NET_GRAD_TOL[dtype]
        if not d <= bound:
            fails.append(f"train {route} {dtype} step 1: {net} grads {d:.3g} from plain's "
                         f"(relative L2; bound {bound:.3g})")
    return {"worst_grad_err": worst, "grad_rel_l2": rel, "fails": fails}


def train_cli(torch, route, dtype, work, save=False):
    """``biasgan_tpu_torch.train.main`` on the route: one epoch of six
    steps; every launch count is set to 0 just before and read just after.
    Returns (launches, the final state, log)."""
    from biasgan_tpu_torch import train

    out = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(out):
        state = train.main(train_argv(route, dtype, work, f"cli_{route}_{dtype}", save))
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: TRAIN_ROUTES[route][1].get(k, 0) * TRAIN_SAMPLES for k in counts}
    check(counts == want, f"train CLI {route} {dtype}: launches {counts}, expected {want}")
    log = out.getvalue()
    lines = [ln for ln in log.splitlines() if ln.startswith("(epoch:")]
    check(len(lines) == TRAIN_SAMPLES, f"train CLI {route} {dtype}: {len(lines)} loss lines")
    check(not any("nan" in ln or "inf" in ln for ln in lines),
          f"train CLI {route} {dtype}: non-finite loss")
    for ln in log.splitlines():
        if ln.startswith("--") or ln.startswith("(epoch: 1, iters: 6") or "End of" in ln:
            print(f"  cli {route} {dtype}: {ln}")
    return counts, state


def check_trained_checkpoint(torch, work, state) -> None:
    """The inference CLI's loader takes G_A from the saved run, and the
    loaded G maps a 256x256 field as the trained one does."""
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.infer import build_generator

    argv = ["--model", "cycle_gan", "--dataset_mode", "synthetic", "--netG", "resnet_9blocks",
            "--ngf", "64", "--no_dropout", "--norm", "instance", "--input_nc", "3",
            "--output_nc", "3", "--compute_dtype", "bfloat16", "--fused_blocks",
            "--checkpoints_dir", os.path.join(work, "train"), "--name", "cli_fused_bfloat16",
            "--device", "cuda"]
    with contextlib.redirect_stdout(io.StringIO()):
        G = build_generator(parse_config(argv), torch.device("cuda"))
    x = torch.randn((1, 256, 256, 3), generator=torch.Generator().manual_seed(9)).cuda()
    with torch.inference_mode():
        got, ref = G(x), state.nets["G_A"].eval()(x)
    err = float((got - ref).abs().max())
    print(f"inference loader: G_A of the trained run, 256x256 forward vs the trained net: "
          f"max|dy| {err:.3g}")
    check(bool(torch.isfinite(got).all()) and err <= 1e-3, "trained checkpoint: G_A differs")


def train_phase(torch, work) -> dict:
    """Every route and dtype: the first step held to plain's, 5 timed
    steps, then the CLI run. Returns the CLI runs' launches per (route,
    dtype) and the timings."""
    out = {"launches": {}, "samples_per_s": {}, "ms_per_step": {}, "worst_grad_err": {},
           "grad_rel_l2": {}, "grad_noise_floor": {}}
    fails = []  # held until every route has run, so one run reads them all
    name = torch.cuda.get_device_name(0)
    for dtype in ("float32", "bfloat16"):
        ref = train_steps(torch, "plain", dtype, work)
        moved = train_steps(torch, "plain", dtype, work, perturb=NOISE_INPUT[dtype],
                            timed_steps=False)
        floor = grad_distance(moved, ref)[1]
        out["grad_noise_floor"][dtype] = floor
        print(f"train plain {dtype}: step-1 gradients on inputs moved by "
              f"{NOISE_INPUT[dtype]:.3g} (relative): relative L2 per net {floor}")
        del moved
        for route in TRAIN_ROUTES:
            got = ref if route == "plain" else train_steps(torch, route, dtype, work)
            held = hold_first_step(route, dtype, got, ref, floor) if route != "plain" else {
                "worst_grad_err": 0.0, "grad_rel_l2": {}, "fails": []}
            fails += held["fails"]
            key = f"{route}/{dtype}"
            out["samples_per_s"][key] = got["samples_per_s"]
            out["ms_per_step"][key] = got["ms_per_step"]
            out["worst_grad_err"][key] = held["worst_grad_err"]
            out["grad_rel_l2"][key] = held["grad_rel_l2"]
            print(f"train {route} {dtype}: step 1 held to plain (largest grad |d| "
                  f"{held['worst_grad_err']:.3g} of max(1, net max); relative L2 per net "
                  f"{held['grad_rel_l2']}); steps 2-6: "
                  f"{got['ms_per_step']} ms/step, {got['samples_per_s']} samples/s "
                  f"(256x256, batch 1) on {name}")
            del got
            save = route == "fused" and dtype == "bfloat16"
            counts, state = train_cli(torch, route, dtype, work, save)
            out["launches"][key] = counts
            if save:
                check_trained_checkpoint(torch, work, state)
            del state
            torch.cuda.empty_cache()
        del ref
    check(not fails, "; ".join(fails))
    return out


def kernel_report(times, errs, grad_times, grad_errs, launches, trained) -> list:
    """The kernels line: each kernel's launches on its main path, error,
    times and bound; the differentiable forms' backward times beside
    cuDNN's through autograd, and their launches on the bf16 training
    routes."""
    per = {"field": "field: each globe call's best time times its calls per field",
           "step": "step: each call's best time times its launches per 256x256 CycleGAN "
                   "step at batch 1"}
    train_per = ("step: each training-shape call's best time times its count per "
                 "256x256 CycleGAN step at batch 1, bf16")
    kernels = []
    for name, (replaces, path) in KERNELS.items():
        t = times[name]
        unit = PER_UNIT[name]
        n = (trained["launches"][f"{path}/bfloat16"][name] if unit == "step"
             else launches[path][name])
        entry = {
            "name": name, "route": "cuda",
            "source": f"biasgan_tpu_torch/kernels/csrc/{name}.cu", "replaces": replaces,
            "launches": n, "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "path": path, "per": per[unit], "calls": t["calls"],
        }
        form = {"conv3x3_valid": "conv3x3_op", "conv7x7": "conv7x7",
                "instance_norm_act": "instance_norm_act"}.get(name)
        if name == "conv3x3_valid":
            entry.update(bwd_launches=trained["launches"][f"{path}/bfloat16"]["conv3x3_valid.bwd"],
                         bwd_kernel_ms=t["bwd_kernel_ms"], max_grad_err=grad_errs[form],
                         bwd_ms=grad_times[form]["bwd_ms"],
                         library_bwd_ms=grad_times[form]["library_bwd_ms"],
                         autograd_ms=grad_times[form]["ms"],
                         library_autograd_ms=grad_times[form]["library_ms"])
        elif form is not None:
            g = grad_times[form]
            entry.update(bwd_ms=g["bwd_ms"], library_bwd_ms=g["library_bwd_ms"], train={
                "route": "all", "launches": trained["launches"]["all/bfloat16"][name],
                "ms": g["ms"], "bwd_ms": g["bwd_ms"], "plain_ms": g["plain_ms"],
                "library_ms": g["library_ms"], "library_bwd_ms": g["library_bwd_ms"],
                "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                "max_grad_err": grad_errs[form], "per": train_per, "calls": g["calls"]})
        elif name == "conv3x3_fused":
            g = grad_times["conv3x3_fused_t"]
            entry["train"] = {
                "name": "conv3x3_fused_t", "replaces": "biasgan_tpu/ops/pallas_conv.py:1091",
                "route": "fused", "launches": trained["launches"]["fused/bfloat16"][
                    "conv3x3_fused_t"], "max_grad_err": grad_errs["conv3x3_fused_t"],
                "ms": g["ms"], "bwd_ms": g["bwd_ms"], "plain_ms": g["plain_ms"],
                "library_ms": g["library_ms"], "library_bwd_ms": g["library_bwd_ms"],
                "bound_ms": g["bound_ms"], "bound_by": g["bound_by"], "per": train_per,
                "calls": g["calls"]}
        kernels.append(entry)
    return kernels


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "biasgan_tpu_torch")):
        print("chip_smoke: no biasgan_tpu_torch package beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = os.path.join(HERE, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        environment(torch)
        build_kernels()
        errs = check_kernels(torch)
        times = time_kernels(torch)
        grad_errs = check_grads(torch)
        grad_times = time_grads(torch)
        check_small_generator(torch)
        launches = serve_globe(torch, work)
        trained = train_phase(torch, work)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"training": trained}))
    print(json.dumps({"kernels": kernel_report(times, errs, grad_times, grad_errs,
                                               launches, trained)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
