#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (biasgan_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

It exits non-zero, printing no result, when CUDA is unavailable or the
checkout is missing, and at the first failure of any phase:

  1. environment: the card (nvidia-smi name and power limit), torch, CUDA,
     nvcc and Triton versions;
  2. build every kernel of the served path from csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card (TF32 off):
     the full-globe block shape (1, 181, 360, 256) in bf16 and f32, with and
     without the prologue, and a sweep of all nine pad-mode pairs at odd
     shapes, with the moments held to those of the stored output; then the
     kernel's time beside the plain version's;
  4. a small-input reference: the generator's kernel path on the card
     against its plain path on the CPU (which the CPU tests hold to the JAX
     package), f32;
  5. a NetCDF-3 store of three 721x1440 fields per side and a seeded
     resnet_9blocks (ngf 64) checkpoint;
  6. serve the fields through ``biasgan_tpu_torch.infer.main`` with
     --fused_blocks, counting kernel launches, and again on the plain path;
     outputs must be finite, of the right shape, and agree with each other.

Before its last line it prints one JSON object with the kernels' names,
sources, launch counts on the served path, errors and times. The last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
GLOBE_H, GLOBE_W, GLOBE_C, N_VARS, N_TIMES = 721, 1440, 256, 3, 3
PAD_MODES = ("zero", "reflect", "wrap")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # |y - ref| <= tol * (1 + |ref|)
MOMENT_TOL = 1e-3  # relative, see moment_error
MOMENT_SLACK = 1e-5  # f32 summation order, see stored_moment_ratio
BLOCK_CONVS = 18  # resnet_9blocks: 9 blocks x 2 convs


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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
    from biasgan_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build("conv3x3_fused")
    build.load("conv3x3_fused")
    print(f"build conv3x3_fused: {time.perf_counter() - t0:.1f} s -> {path}")
    with open(path + ".log") as f:
        print(f.read().strip())


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
    """Moments of the stored value (the Pallas kernel's rule,
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


def kernel_case(torch, g, n, h, w, c, cout, dtype, prologue, h_mode, w_mode):
    """One kernel-vs-plain comparison; returns max |y - ref| and the
    stored-value moment ratio."""
    from biasgan_tpu_torch.kernels.conv3x3_fused import (
        conv3x3_fused,
        conv3x3_fused_plain,
    )

    dev = "cuda"
    x = torch.randn((n, h, w, c), generator=g, device=dev).to(dtype)
    wt = torch.randn((cout, c, 3, 3), generator=g, device=dev) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn((cout,), generator=g, device=dev)
    pro = None
    if prologue:
        pro = (
            0.5 + torch.rand((n, c), generator=g, device=dev),
            0.5 * torch.randn((n, c), generator=g, device=dev),
        )
    args = (x, wt.to(dtype), bias, pro, "relu", h_mode, w_mode, True)
    y, m = conv3x3_fused(*args)
    ry, rm = conv3x3_fused_plain(*args)
    torch.cuda.synchronize()
    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    yf, rf = y.float(), ry.float()
    err = float((yf - rf).abs().max())
    bound = tol * (1 + rf.abs())
    where = f"{name} {(n, h, w, c, cout)} prologue={prologue} h={h_mode} w={w_mode}"
    check(bool(torch.isfinite(yf).all()), f"non-finite kernel output: {where}")
    check(bool(((yf - rf).abs() <= bound).all()), f"y off by {err:.3g}: {where}")
    merr = moment_error(m, rm, h * w)
    check(merr <= MOMENT_TOL, f"moments off by {merr:.3g} (relative): {where}")
    ratio = stored_moment_ratio(y, m, ry, rm)
    check(ratio <= 1, f"moments {ratio:.3g}x further off than the stored y allows: {where}")
    return err, ratio


def check_kernels(torch) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    globe = (1, 181, 360, GLOBE_C, GLOBE_C)
    globe_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for prologue in (False, True):
            err, ratio = kernel_case(torch, g, *globe, dtype, prologue, "reflect", "wrap")
            print(f"conv3x3_fused globe {dtype} prologue={prologue}: max|dy| {err:.3g}, "
                  f"moments at {ratio:.3g} of the stored-value bound")
            if dtype == torch.bfloat16:
                globe_err = max(globe_err, err)
    n_cases, worst = 0, 0.0
    for c, cout in ((3, 5), (32, 48), (256, 256)):
        for h_mode in PAD_MODES:
            for w_mode in PAD_MODES:
                for dtype in (torch.bfloat16, torch.float32):
                    prologue = (n_cases % 2) == 1
                    _, ratio = kernel_case(torch, g, 2, 13, 37, c, cout, dtype,
                                           prologue, h_mode, w_mode)
                    worst = max(worst, ratio)
                    n_cases += 1
    print(f"conv3x3_fused pad-mode sweep: {n_cases} cases within tolerance; "
          f"moments at most {worst:.3g} of the stored-value bound")
    return {"max_abs_err": globe_err}


def time_kernel(torch) -> dict:
    """Kernel vs plain version at the globe block shape in bf16, with the
    prologue and moments (conv1 of a block), and beside them the same op
    with a bf16 cuDNN conv; in turns, CUDA events over 20 calls each after a
    warm-up."""
    from biasgan_tpu_torch.kernels.conv3x3_fused import (
        conv3x3_fused,
        conv3x3_fused_plain,
    )
    from biasgan_tpu_torch.ops.padding import pad_hw

    g = torch.Generator(device="cuda").manual_seed(1)
    n, h, w, c = 1, 181, 360, GLOBE_C
    x = torch.randn((n, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((c, c, 3, 3), generator=g, device="cuda") / (9 * c) ** 0.5).to(
        torch.bfloat16
    )
    bias = 0.1 * torch.randn((c,), generator=g, device="cuda")
    pro = (
        0.5 + torch.rand((n, c), generator=g, device="cuda"),
        0.5 * torch.randn((n, c), generator=g, device="cuda"),
    )
    args = (x, wt, bias, pro, "relu", "reflect", "wrap", True)

    def timed(fn, iters=20):
        for _ in range(3):
            fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def cudnn_bf16(x, wt, bias, pro, act, h_mode, w_mode, _):
        """The same op on the plain generator path's terms: prologue, pad,
        a bf16 cuDNN conv, bias, moments (not the checked reference: it
        rounds differently, see conv3x3_fused_plain)."""
        xf = torch.clamp(x.float() * pro[0][:, None, None, :] + pro[1][:, None, None, :], min=0)
        xp = pad_hw(xf.to(x.dtype), (1, 1), (1, 1), h_mode, w_mode)
        y = torch.nn.functional.conv2d(xp.permute(0, 3, 1, 2), wt).permute(0, 2, 3, 1)
        y = (y + bias.to(y.dtype)).float()
        return y, (y.sum((1, 2)), y.square().sum((1, 2)))

    fns = {"plain": conv3x3_fused_plain, "kernel": conv3x3_fused, "cudnn_bf16": cudnn_bf16}
    runs = {k: [] for k in fns}
    for which in ("plain", "cudnn_bf16", "kernel", "kernel", "cudnn_bf16", "plain"):
        runs[which].append(timed(fns[which]))
    best = {k: min(v) for k, v in runs.items()}
    flops = 2 * n * h * w * 9 * c * c
    print(f"conv3x3_fused (1,{h},{w},{c}) bf16 + prologue + moments, ms per call "
          "(CUDA events, 20 calls after 3 warm-up, in turns):")
    for k, v in runs.items():
        print(f"  {k}: {v} -> best {best[k]:.4f} ms ({flops / best[k] / 1e9:.1f} TFLOP/s)")
    return {"ms": best["kernel"], "plain_ms": best["plain"]}


def check_small_generator(torch) -> None:
    """The generator's kernel path on the card against its plain path on
    the CPU, f32, tiny shape."""
    from biasgan_tpu_torch.nn import define_G

    g = torch.Generator().manual_seed(2)
    G = define_G(
        "resnet_2blocks", 3, 3, ngf=16, norm="instance", w_mode="wrap",
        out_activation="none", generator=g,
    ).eval()
    x = torch.randn((1, 13, 40, 3), generator=g)
    with torch.inference_mode():
        ref = G(x)
        G.fused_blocks = True
        got = G.to("cuda")(x.to("cuda")).cpu()
    err = float((got - ref).abs().max())
    print(f"resnet_2blocks (1,13,40,3) f32: card kernel path vs CPU plain max|dy| {err:.3g}")
    check(err <= 2e-4 * (1 + float(ref.abs().max())), f"small generator off by {err:.3g}")


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


def serve(torch, work: str, fused: bool):
    """One infer.main run over the store; returns (fields, per-field ms,
    per-field Mpx/s, kernel launches)."""
    import numpy as np

    from biasgan_tpu_torch import infer
    from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused

    tag = "fused" if fused else "plain"
    argv = [
        "--model", "pix2pix", "--dataset_mode", "climate",
        "--dataroot", os.path.join(work, "data"),
        "--checkpoints_dir", os.path.join(work, "ckpt"), "--name", "globe",
        "--results_dir", os.path.join(work, "results_" + tag),
        "--full_field", "--compute_dtype", "bfloat16",
        "--netG", "resnet_9blocks", "--ngf", "64", "--norm", "instance",
        "--no_dropout", "--w_pad_mode", "wrap", "--netG_activation", "none",
        "--input_nc", str(N_VARS), "--output_nc", str(N_VARS),
        "--num_test", str(N_TIMES), "--device", "cuda",
    ] + (["--fused_blocks"] if fused else [])
    out = io.StringIO()
    conv3x3_fused.launches = 0
    with contextlib.redirect_stdout(out):
        out_dir = infer.main(argv)
    launches = conv3x3_fused.launches
    log = out.getvalue()
    lines = [ln for ln in log.splitlines() if ln.startswith("[") or "fused_blocks" in ln]
    print("\n".join(f"  {tag}: {ln}" for ln in lines))
    stamps = re.findall(r"corrected in ([0-9.]+) ms \(([0-9.]+) Mpx/s\)", log)
    check(len(stamps) == N_TIMES, f"{tag}: expected {N_TIMES} served fields, got {len(stamps)}")
    fields = []
    for i in range(N_TIMES):
        y = np.load(os.path.join(out_dir, f"corrected_{i:05d}.npy"))
        check(y.shape == (1, GLOBE_H, GLOBE_W, N_VARS), f"{tag}: field {i} shape {y.shape}")
        check(bool(np.isfinite(y).all()), f"{tag}: field {i} has non-finite values")
        fields.append(y)
    return fields, [float(s[0]) for s in stamps], [float(s[1]) for s in stamps], launches


def serve_globe(torch, work: str) -> int:
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

    fused, f_ms, f_mpx, launches = serve(torch, work, fused=True)
    plain, p_ms, p_mpx, plain_launches = serve(torch, work, fused=False)
    check(
        launches == BLOCK_CONVS * N_TIMES,
        f"fused run launched conv3x3_fused {launches} times, expected "
        f"{BLOCK_CONVS} per field x {N_TIMES}",
    )
    check(plain_launches == 0, f"plain run launched the kernel {plain_launches} times")
    # field 0 of both paths: bf16 rounds at different places on the two, so
    # hold them to the repo's own bf16 globe rule (tests/integration/
    # test_infer_globe.py:107: rtol 2e-2, atol 1 K at a std of ~10 K, i.e.
    # |dy| <= 0.02 |y| + 0.1 std of the target variable), and the mean
    # |dy| to 0.01 std
    sd = stats.load_or_compute_stats(
        os.path.join(work, "data", "stats_B.json"), [], [f"var{v}" for v in range(N_VARS)]
    )
    std = np.array([sd[f"var{v}"]["std"] for v in range(N_VARS)], np.float32)
    diff = np.abs(fused[0] - plain[0])
    excess = diff - (0.02 * np.abs(plain[0]) + 0.1 * std)
    print(
        f"field 0, fused vs plain path: max |dy| {float((diff / std).max()):.4g} std, "
        f"mean |dy| {float((diff / std).mean()):.4g} std, "
        f"worst margin to the bf16 bound {float(excess.max()):.4g}"
    )
    check(float(excess.max()) <= 0 and float((diff / std).mean()) <= 0.01,
          "fused and plain globe outputs disagree beyond bf16 tolerance")
    name = torch.cuda.get_device_name(0)
    for tag, ms, mpx in (("fused", f_ms, f_mpx), ("plain", p_ms, p_mpx)):
        print(
            f"globe {GLOBE_H}x{GLOBE_W}x{N_VARS} bf16 {tag}: ms/field {ms} "
            f"(field 0 warms up; median of the rest {statistics.median(ms[1:]):.1f}), "
            f"Mpx/s {mpx} on {name}"
        )
    return launches


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
        kstats = check_kernels(torch)
        kstats.update(time_kernel(torch))
        check_small_generator(torch)
        launches = serve_globe(torch, work)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": [{
        "name": "conv3x3_fused",
        "route": "cuda",
        "source": "biasgan_tpu_torch/kernels/csrc/conv3x3_fused.cu",
        "replaces": "biasgan_tpu/ops/pallas_conv.py:771",
        "launches": launches,
        "max_abs_err": kstats["max_abs_err"],
        "ms": kstats["ms"],
        "plain_ms": kstats["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
