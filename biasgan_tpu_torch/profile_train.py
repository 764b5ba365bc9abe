"""Step time and device-time breakdown of the full-width CycleGAN training
step on one CUDA device, on the four kernel routes of ``train.py``:

    python -m biasgan_tpu_torch.profile_train [--out FILE.json] [--dtype bfloat16]

* plain: cuDNN convs, instance norms and pads;
* fused: --fused_blocks (the block convs through conv3x3_fused_t);
* pallas_conv: --pallas_conv 1 (the block convs and their input gradients
  through conv3x3_valid);
* all: --fused_blocks --conv7_pallas 1 --force_pallas_norm.

The model is the reference CycleGAN at its defaults (resnet_9blocks ngf 64,
basic D ndf 64, instance norm, lsgan, pool 50, Adam), 256x256 crops, batch
1, 3 channels, seeded weights and synthetic fields (``data/synthetic.py``);
the numbers do not depend on the values. Rounds run the four routes in that
order, twice, each from a fresh state, and each round measures:

* wall: STEPS steps after WARMUP steps, host clock between
  ``torch.cuda.synchronize()`` calls, ms per step;
* profile: ``torch.profiler`` over PROFILED steps: device busy ms per step
  (the sum of the kernels' self device time), the largest kernels, the
  idle share 1 - busy / wall, the device kernels per step (every kernel the
  card ran, library and hand-written), and each hand-written kernel's
  launches per step.

It prints one line per round and, with --out, writes every number to a
JSON file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.data import create_dataset
from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused, conv3x3_fused_bwd
from biasgan_tpu_torch.kernels.conv3x3_valid import conv3x3_valid
from biasgan_tpu_torch.kernels.conv7x7 import conv7x7
from biasgan_tpu_torch.kernels.instance_norm_act import instance_norm_act, instance_norm_act_bwd
from biasgan_tpu_torch.models.common import step_generator
from biasgan_tpu_torch.models.cyclegan import create_state, make_train_step
from biasgan_tpu_torch.profile_globe import _device_rows
from biasgan_tpu_torch.train import batch_to

WARMUP, STEPS, PROFILED, TOP = 3, 10, 3, 16
SAMPLES = WARMUP + STEPS + PROFILED
ARGS = [
    "--model", "cycle_gan", "--dataset_mode", "synthetic", "--netG", "resnet_9blocks",
    "--ngf", "64", "--netD", "basic", "--ndf", "64", "--norm", "instance", "--no_dropout",
    "--crop_size", "256", "--batch_size", "1", "--input_nc", "3", "--output_nc", "3",
    "--synthetic_samples", str(SAMPLES), "--device", "cuda",
]
ROUTES = {
    "plain": [],
    "fused": ["--fused_blocks"],
    "pallas_conv": ["--pallas_conv", "1"],
    "all": ["--fused_blocks", "--conv7_pallas", "1", "--force_pallas_norm"],
}
KERNELS = {"conv3x3_fused": (conv3x3_fused, "launches"),
           "conv3x3_fused_bwd": (conv3x3_fused_bwd, "launches"),
           "conv3x3_valid": (conv3x3_valid, "launches"),
           "conv3x3_valid.bwd": (conv3x3_valid, "bwd_launches"),
           "conv7x7": (conv7x7, "launches"),
           "instance_norm_act": (instance_norm_act, "launches"),
           "instance_norm_act_bwd": (instance_norm_act_bwd, "launches")}


def profile_round(route: str, dtype: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = parse_config(ARGS + ROUTES[route] + ["--compute_dtype", dtype], train=True)
    cfg.steps_per_epoch = SAMPLES
    dev = torch.device("cuda")
    batches = [batch_to(d, dev) for d in create_dataset(cfg)]
    state = create_state(cfg, dev)
    step = make_train_step(cfg)
    i = 0

    def run(n):
        nonlocal i
        for _ in range(n):
            step(state, batches[i], step_generator(cfg.seed, i))
            i += 1

    run(WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(STEPS)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / STEPS
    before = {k: getattr(f, a) for k, (f, a) in KERNELS.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(PROFILED)
        torch.cuda.synchronize()
    launches = {k: (getattr(f, a) - before[k]) / PROFILED for k, (f, a) in KERNELS.items()}
    busy, top = _device_rows(prof, PROFILED, TOP)
    device_kernels = sum(e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time for the steps")
    return {
        "route": route, "dtype": dtype, "wall_ms_per_step": wall,
        "samples_per_s": cfg.batch_size * 1e3 / wall,
        "device_busy_ms_per_step": busy, "idle_share": 1 - busy / wall,
        "device_kernels_per_step": device_kernels / PROFILED,
        "launches_per_step": launches, "top_kernels": top,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="", help="write every number to this JSON file")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rounds = []
    for route in list(ROUTES) * 2:
        r = profile_round(route, args.dtype)
        rounds.append(r)
        kernels = ", ".join(f"{k} {n:g}" for k, n in r["launches_per_step"].items() if n)
        print(
            f"{route} {args.dtype}: wall {r['wall_ms_per_step']:.3f} ms/step "
            f"({r['samples_per_s']:.3f} samples/s, {STEPS} steps), device busy "
            f"{r['device_busy_ms_per_step']:.3f} ms/step, idle share {r['idle_share']:.3f}, "
            f"{r['device_kernels_per_step']:g} device kernels/step; "
            f"launches/step: {kernels or 'none'}"
        )
        for ms, calls, key in r["top_kernels"]:
            print(f"  {ms:8.3f} ms/step {calls:6.1f} calls/step  {key}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "dtype": args.dtype, "rounds": rounds}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
