#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (biasgan_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

It exits non-zero, printing no result, when CUDA is unavailable or the
checkout is missing, and at the first failure of any phase:

  1. environment: the card (nvidia-smi name and power limit), torch, CUDA,
     nvcc and Triton versions;
  2. build every kernel of the served, sharded and trained paths from csrc/
     (nvcc, sm_90a) as a check build (BIASGAN_KERNEL_WATCHDOG=1: an mbarrier
     wait that never ends traps), one nvcc per source, all started together (the fused
     block conv's and the instance norm's backward among them); the bf16
     kernels of the block conv, the down conv, the up conv-transpose, the
     VALID conv (the block conv's tile loop) and the 7x7 conv (its stem and
     head kernels together) must hold wgmma (HGMMA) and TMA (UTMALDG,
     UTMASTG) instructions (cuobjdump);
  3. each kernel against its plain PyTorch version on the card (TF32 off):
     at the shapes its main path gives it (the full-globe serve, or for
     the VALID 3x3 conv the 256x256 CycleGAN step), in bf16 and f32, and
     over a sweep of small odd shapes, pad modes, prologues, activations
     and residuals, with the moments held to those of the stored output
     (the block conv's sweep also with tiles touching both edges in every
     pad mode pair, channels the wrapper pads, and batch 2 with more tiles
     than SMs; the VALID conv's likewise under every epilogue; the 7x7
     conv's with stem tiles and head units touching both edges, every Cin
     and Cout side the CPU emulation test takes, two channel blocks, and
     batch 2 with more stem tiles than SMs and head units in two rounds;
     the up conv-transpose's with tiles touching all four edges, padded C
     and Cout, three cout blocks, and batch 2 with more units than SMs;
     the block conv, the stride-2 down conv, the up conv-transpose, the
     VALID conv and the 7x7 conv on the path their wrappers' rule gives:
     every bf16 call on the tensor-core (wgmma) kernel,
     counted apart, printed per globe shape); the instance norm's forward
     on each of its two one-launch paths (cluster, persistent) at the
     sweep's, the globe's and the training step's shapes, the statistics
     held too, each call repeated bitwise and counted on its path; the VALID conv's input
     gradient (conv3x3_valid_dx: the kernel's pad of 2 on the unpadded
     cotangent) likewise, at the training step's cotangents, the globe's
     and small shapes;
     then, at those shapes in bf16, the kernel's time beside the plain
     version's, one PyTorch library call's, and the card's bound for the
     same work, and the kernel call's device time by kernel from
     torch.profiler beside its CUDA-event time (the host work of the call,
     such as a weight repack, apart from the kernels); where the parent
     commit's tree is unpacked in .chip_archive/parent, the kernels of
     COMPARE_KERNELS there and here in turns at the shapes of TURN_CALLS,
     each turn a fresh process (phase 6 runs the turns; the parent's
     input gradient is what its backward ran: F.pad of the cotangent and
     the VALID call); the fused block
     conv also in its halo W
     mode at the block shape of a 4-way W shard; then the halo exchange
     inside four spawned ranks (one card: gloo, the ranks sharing it, on
     the host-synchronised route; a card per rank: NCCL, on the signalled
     route, every exchange counted as signalled): the kernel bitwise
     against the plain ring at every exchange shape of the sharded globe
     forward, periodic and zero-edge, and its times (the host route's copy
     alone under CUDA events around rank 0's launches, the signalled
     route's two kernels on the card by torch.profiler), the whole exchange
     back to back, the plain ring's and the ring's messages alone; then the
     signalled route on this card through a loopback ring (2 and 4 peers in
     this process, each its own slab and stream, their kernels co-resident):
     64 back-to-back exchanges with fresh shards at every exchange shape,
     periodic and zero-edge, every halo bitwise the ring's, and its device
     time per exchange;
  3b. the gradient phase: the fused block conv's backward kernel
     (conv3x3_fused_bwd; bf16 on its TMA / wgmma kernels, every call
     counted, two calls bitwise equal) called directly against its plain
     version (the torch-ops backward) on the same inputs and cotangents,
     over every H pad
     with every W mode (the halo mode with wrap and zero-edge columns), the
     prologue under each act and without, moments and bias on and off,
     ragged and tiny shapes and the training shapes, f32 and bf16; each
     differentiable kernel (the fused block conv of training, whose
     backward is that kernel, also in its halo W mode with wrap and
     zero-edge halo columns at the sharded step's block shape and ragged
     widths; the VALID 3x3 op, the 7x7 conv, the fused instance norm) under
     autograd against autograd through its plain version on the card, f32
     and bf16, with the JAX tests' bounds; then, at the training shapes in
     bf16, each one's forward and backward times beside cuDNN's through
     autograd, and the card's forward and backward bounds; for the fused
     block conv and the instance norm also, in turns, the backward kernel
     called directly and the old torch-ops backward (the plain version),
     and the device kernels each backward runs (torch.profiler, checked
     profiles, in a fresh process: late in this long process the profiler
     drops events); the instance norm's backward kernel (instance_norm_act_bwd) called
     directly against its plain version on the forward kernel's output and
     saved statistics, at every training shape of the all-kernel route,
     H W = 1 and C = 12, every act with and without a residual, f32 and
     bf16 (the residual's gradient bitwise);
  4. a small-input reference: the generator's kernel paths on the card
     against its plain path on the CPU (which the CPU tests hold to the JAX
     package), f32; and the sharded forward on four ranks on the card (the
     plain ring and the halo kernel, with and without the fused blocks)
     against the whole-field forward, f32, with its launch counts;
  5. a NetCDF-3 store of three 721x1440 fields per side and a seeded
     resnet_9blocks (ngf 64) checkpoint;
  6. serve the fields through ``biasgan_tpu_torch.infer.main`` on four
     paths, counting each kernel's launches (the wgmma kernels' also on
     their bf16 path: all of them, on every path and rank):
     --fused_blocks; the plain
     path; --fused_blocks --fused_updown --conv7_pallas 1; and
     --force_pallas_norm; then spatially sharded over four ranks on the
     card: --spatial_mesh 4 (the plain ring), with --halo_rdma, and with
     --halo_rdma --fused_blocks, each rank's launches counted in its own
     process from 0, and the --halo_rdma paths' exchanges on each rank all
     on the route the cards give (a card per rank: signalled, no host
     sync; one card: the host route's two syncs each). Outputs must be
     finite, of the right shape, and each path must agree with the plain
     path by the globe bf16 rule (every path serves the 1440 columns
     unpadded); --halo_rdma with the ring's. With a parent tree, the three
     sharded paths' served ms/field and the halo exchange per forward,
     there and here in turns;
  (the --force_pallas_norm path's 23 instance norms a field each on the
     path the norm's plan names, counted per path);
  7. train full-width CycleGAN (resnet_9blocks ngf 64, basic D ndf 64,
     instance norm, lsgan, pool 50, 256x256, batch 1, 3 channels,
     synthetic data from a seed) in f32 and bf16 on four routes: plain;
     --fused_blocks; --pallas_conv 1; and --fused_blocks --conv7_pallas 1
     --force_pallas_norm. Each route's first step, from the same state and
     batch, is held to the plain route's (losses and step-1 gradients) with
     exact kernel launch counts (the block conv: 54 per step on the
     --fused_blocks routes, in bf16 all on its TMA / wgmma kernel; its
     backward kernel: 54 per step there, 0 elsewhere; the VALID conv's
     forward and input gradient: 54 each per step on --pallas_conv 1, in
     bf16 all 108 on its TMA / wgmma kernel; the instance norm's backward
     kernel: 27 per step on the all-kernel route, as the instance norm's
     forward, each on the path its plan names); then
     ``biasgan_tpu_torch.train.main`` runs six steps on the route, counting
     launches, with finite losses, and its samples/s over steps 2-6 is
     printed. The checkpoint of one run is
     loaded by the inference CLI's loader;
  8. the same CycleGAN with --w_pad_mode wrap, spatially sharded over four
     ranks on the card (--spatial_mesh 4), on two routes: --fused_blocks
     (the block conv's halo W mode, forward and backward kernel 54 launches
     each per rank per step) and the plain one. Step 1 of each, f32 and
     bf16, from the seeded state and the first batch, is held to the one-card plain step 1 of the same
     configuration (losses and per-net gradients, by the rules of 7), with
     exact launch counts per rank and every rank's parameters bitwise
     equal; then ``train.main --spatial_mesh 4`` runs three bf16 steps on
     each route (finite losses, exact launches, equal parameters), and
     rank 0's ms/step is printed;
  9. pix2pix, the reference's default model: the JAX bench's
     configuration (unet_256 G, basic D, batch norm, vanilla + L1, no
     pool, dropout on, 256x256, 3 channels, ngf / ndf 64) through
     ``biasgan_tpu_torch.train.main`` in bf16 at batch 1, six steps and a
     save (finite losses, no kernel launched, every saved running mean
     moved from 0); step 1 with dropout off in f32 on the card and on the
     CPU (which the CPU tests hold to JAX), for vanilla, lsgan and wgangp
     (its alpha from the step's seeded CPU generator), held by the rules
     of 7, the noise floor the larger of the card's and the CPU's; three
     bf16 steps at bench.py's batch of 128 (ms/step, samples/s,
     max_memory_allocated); the step on
     a kernel route (resnet_9blocks, instance norm, --fused_blocks, lsgan,
     bf16): step 1 held to the same step without the flag, then the CLI's
     two steps with K2's forward and backward on each of the 18 block
     convs once a step, exact; and the saved U-Net serving one field of
     the store of 5 through ``biasgan_tpu_torch.infer.main``;
  10. data parallelism over two ranks (one card: gloo, the ranks sharing
     it through host copies; a card per rank: NCCL; a notice line says
     which): the bench configuration (batch norm, dropout on, bf16) at
     global batch 128 through ``biasgan_tpu_torch.train.main --data_mesh
     2`` for five steps with --val_split and --val_freq (both validation
     lines; ms/step, samples/s, each rank's count of the grads'
     all-reduces and peak memory; every rank's parameters, running averages
     and pools bitwise equal; no kernel launched); step 1 in f32 at global
     batch 2, dropout off: instance norm, the card's ranks against the
     one-card step on the global batch, batch norm, the card's ranks
     against two CPU ranks (which the CPU tests hold to JAX's
     data-parallel step), by the rules of 7 with phase 9's noise floors;
     CycleGAN at its defaults with --data_mesh 2 for two bf16 steps on
     three kernel routes of 7 (--fused_blocks: K2's forward, all on its
     wgmma kernel, and backward 54 launches per rank per step;
     --pallas_conv 1: the VALID conv's 54 forwards and 54 input gradients;
     the all-kernel route: the 7x7 conv's 6, the instance norm's 27
     forwards on the paths its plan names and 27 backwards), each rank's
     launches exact; and the validation metric bundle
     on the card against the CPU for the same fields (rmse, bias and the
     log-spectral distance within 1e-4 relative, pdf_tv within one
     count), with its time on the card. The phase prints its seconds;
  11. the sharded pix2pix step and the 2-D mesh (ranks sharing one card
     talk over gloo; a card per rank, NCCL): (a) the bench configuration
     at 512x512 (each of two W shards 256 wide, the least width at which
     unet_256's eight downs split) through ``biasgan_tpu_torch.train.main
     --spatial_mesh 2 --w_pad_mode wrap``, batch 1, three bf16 steps
     (finite losses, no kernel launched, parameters and running averages
     bitwise equal on both ranks; rank 0's ms/step, each rank's peak
     memory); (b) its f32 step 1 with dropout on, vanilla and wgangp, the
     two card ranks held to the one-card step on the whole field from the
     same weights and step generator (every rank of a row draws the
     whole-W dropout mask), by the rules of 7 with phase 9's noise floors;
     (c) the resnet route (resnet_9blocks, instance norm, --fused_blocks,
     lsgan) at 256x256 over two shards: step 1 held to the same sharded
     step without the flag, then two bf16 CLI steps with K2's forward (all
     on wgmma) and backward 18 launches each per rank per step, in the halo
     W mode; (d) the 2-D mesh, --data_mesh 2 --spatial_mesh 2 (four
     ranks), on the bench configuration at 512x512, global batch 2, three
     bf16 steps with --val_split 2 --val_freq 2 (both validation lines,
     every rank bitwise equal, each rank's count of the grads'
     all-reduces and peak memory), and its f32 step 1 with dropout on held
     to the --data_mesh 2 step on the card (batch statistics per data rank
     in both); (e) CycleGAN at its defaults with --fused_blocks --w_pad_mode
     wrap on the 2-D mesh, 256x256, global batch 2, two bf16 steps, K2's
     forward (all on wgmma) and backward 54 launches each per rank per
     step, every rank bitwise equal. The phase prints its seconds;
  12. the test driver and the image datasets, on one card: (a) CycleGAN
     at its defaults (resnet_9blocks, instance norm, no --dataset_mode, so
     'unaligned') on 256² PNG folders written from a seed (four trainA,
     three trainB), --fused_blocks, bf16, two steps with a page a step
     (--display_freq 1) and --check_finite 1: finite losses, K2's forward
     (all on wgmma) and backward 54 launches each a step; (b) its G_A
     through ``biasgan_tpu_torch.test --model test --model_suffix _A
     --dataset_mode single`` over four testA images at full width, f32 and
     bf16, on five routes: plain; the reference's training-mode forward on
     --fused_blocks --fused_updown --conv7_pallas 1 --force_pallas_norm
     (K1 18, K3 2, K7 5 an image: the fused down and up kernels have no
     training-mode path); the same with --eval (K1 18, K3 2, K4 2, K5 2);
     --force_pallas_norm (K7 23); --pallas_conv 1 (K6 18); launches per
     image exact, ms per image printed, the page and two PNGs per image
     written; each f32 route within the globe rule of 6 of plain f32, each
     bf16 route within NOISE_FACTOR times plain bf16's own distance from
     plain f32 (plain bf16 alone breaks the globe rule at these images);
     (c) the bench configuration's U-Net (unet_256, batch norm, dropout,
     bf16) from a one-step checkpoint over one aligned image under two
     names: without --eval the two forwards differ (fresh dropout masks)
     and G's running averages stay bitwise as saved; with --eval two runs
     are bitwise equal. Without Pillow, (a) trains on synthetic data and
     (b)-(c) run the test driver's loop with no page (a line says so). The
     phase prints its seconds.
  13. K steps a call, the bf16 Adam moment, the threaded loader: (a) the
     slice's path, the bench configuration (pix2pix unet_256, batch norm,
     vanilla + L1, dropout on, 256x256, bf16) at batch 128 with
     --steps_per_call 4: three calls of ``models.common.make_scan_step`` on
     a stack on the card (ms/step, samples/s, max_memory_allocated beside
     phase 9's one step a call), the synchronizing calls of one more call
     counted by ``torch.cuda.set_sync_debug_mode('warn')`` and where they
     are made; ``train.main --steps_per_call 4`` for three calls (the loss
     lines at iters 512, 1024, 1536, no kernel launched); one K=2 call at
     batch 2 held to two single steps by the rules of 7 (each step's
     losses; the first moments after it, mu / (1 - b1), for gradients); (b)
     CycleGAN on the all-kernel route of 7 with --steps_per_call 2: one
     call held to two single steps by the rules of 7, its launches exactly
     twice phase 7's per step, every bf16 K2 and K3 forward on wgmma, then
     the CLI's three calls with launches exact; (c) --adam_mu_dtype
     bfloat16 on the bench configuration at batch 128, three steps: every
     first moment bf16, the parameters within 2 x 3 lr of the f32
     moment's run from the same state and draws (the bound of
     tests/unit/test_adam_mu_bf16.py), its losses within 2e-2; (d)
     --num_threads 4 against 0 on phase 5's store (whole 721x1440 fields,
     batch 1, three epochs): batches bitwise equal, ms per batch both
     ways; (e) CycleGAN --fused_blocks bf16 with --steps_per_call 2 under
     --data_mesh 2 and on the 2-D mesh (--data_mesh 2 --spatial_mesh 2),
     global batch 2, two calls each: every rank bitwise equal, K2's forward
     (all on wgmma) and backward 54 launches each per rank per step. The
     phase prints its seconds.

On a host with a card per rank the sharded phases run over NCCL, the halo
kernel writing across NVLink peers and signalling on the device.

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
# bf16 on the tensor cores, f32 outside them, device memory, NVLink one way
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
NVLINK_BYTES = 450e9
N_RANKS = 4  # the sharded paths: --spatial_mesh 4, rank r on cuda:(r % cards)
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
    # sharded over N_RANKS ranks: launches per field per rank
    "spatial": (["--spatial_mesh", str(N_RANKS)], {}),
    "spatial_rdma": (["--spatial_mesh", str(N_RANKS), "--halo_rdma"], {"halo_exchange_w": 24}),
    "spatial_rdma_fused": (["--spatial_mesh", str(N_RANKS), "--halo_rdma", "--fused_blocks"],
                           {"halo_exchange_w": 24, "conv3x3_fused": 18}),
}
# kernel -> the wrapper's count of launches on its bf16 path, where the
# wrapper routes by a rule (K1, K2's backward, K3, K4, K5, K6: bf16 takes
# the TMA / wgmma kernels, f32 the CUDA-core checkers); every bf16 call must
# take it (K6's forward and input-gradient launches alike)
PATH_COUNTERS = {"conv3x3_fused": "wgmma_launches", "conv3x3s2_fused": "wgmma_launches",
                 "convt3x3s2_fused": "wgmma_launches", "conv3x3_valid": "wgmma_launches",
                 "conv7x7": "wgmma_launches", "conv3x3_fused_bwd": "wgmma_launches"}
# the instance norm's paths, each counted in instance_norm_act.<path>_launches
NORM_PATHS = ("cluster", "persistent")
# source -> its bf16 TMA / wgmma kernels (parts of cuobjdump's function
# names, and whether each stores by TMA; K6's is K1's tile loop,
# csrc/conv3x3_tma.cuh; K3's the stem's and the head's, stem_wgmma_kernel
# and head_wgmma_kernel; K2's backward the same loop for its input gradient
# and wgrad_tma_kernel, which loads by TMA and stores its partials itself)
WGMMA_KERNELS = {"conv3x3_fused": {"conv_tma_kernel": True},
                 "conv3x3s2_fused": {"down_tma_kernel": True},
                 "convt3x3s2_fused": {"up_tma_kernel": True},
                 "conv3x3_valid": {"conv_tma_kernel": True},
                 "conv7x7": {"_wgmma_kernel": True},
                 "conv3x3_fused_bwd": {"conv_tma_kernel": True, "wgrad_tma_kernel": False}}
# the halo exchanges of one sharded globe forward, per rank: (the local
# tensor's shape, dtype, left, right, exchanges per forward). W 1440 is 360
# per rank; bf16 compute, but the stem pads the f32 input; H is padded
# before W, except in the fused block convs, which pad H in the kernel.
_EDGE_CALLS = [
    ((1, 730, 360, 3), "float32", 3, 3, 1),  # stem (H reflect 3)
    ((1, 726, 360, 64), "bfloat16", 1, 1, 1),  # down0 (H zero 1)
    ((1, 364, 180, 128), "bfloat16", 1, 1, 1),  # down1
]
_UP_CALLS = [
    ((1, 181, 180, 256), "bfloat16", 1, 1, 1),  # up0, on the W-dilated input
    ((1, 362, 360, 128), "bfloat16", 1, 1, 1),  # up1
    ((1, 730, 360, 64), "bfloat16", 3, 3, 1),  # head (H reflect 3)
]
HALO_CALLS = {
    "spatial_rdma": _EDGE_CALLS + [((1, 183, 90, 256), "bfloat16", 1, 1, 18)] + _UP_CALLS,
    "spatial_rdma_fused": _EDGE_CALLS + [((1, 181, 90, 256), "bfloat16", 1, 1, 18)] + _UP_CALLS,
}


class SmokeFailure(Exception):
    pass


def with_path_counts(per_call: dict, dtype: str, norms=()) -> dict:
    """``per_call`` (kernel -> launches) with each PATH_COUNTERS count
    beside it: every launch on the bf16 path in bf16 (a kernel's
    ``<name>.bwd`` launches, the VALID conv's input gradients, too), none
    in f32; and the instance norm's launches on each of its two paths, as
    its plan names the path of each of ``norms`` ((NHWC shape, calls) of
    its forward; NORM_CALLS)."""
    out = dict(per_call)
    for name, attr in PATH_COUNTERS.items():
        n = per_call.get(name, 0) + per_call.get(f"{name}.bwd", 0)
        out[f"{name}.{attr}"] = n if dtype == "bfloat16" else 0
    out.update({f"instance_norm_act.{path}_launches": 0 for path in NORM_PATHS})
    for shape, count in norms:
        out[f"instance_norm_act.{norm_path(shape, dtype)}_launches"] += count
    return out


def norm_path(shape, dtype) -> str:
    """The path the instance norm's plan names for an NHWC ``shape``."""
    import torch

    from biasgan_tpu_torch.kernels.common import sm_count
    from biasgan_tpu_torch.kernels.instance_norm_act import norm_plan

    n, h, w, c = shape
    es = torch.finfo(getattr(torch, str(dtype).replace("torch.", ""))).bits // 8
    return norm_plan(n, h * w, c, es, sm_count(torch.device("cuda"))).path


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def kernel_fns(name: str, bwd: bool = False):
    """(wrapper, plain version) of kernel ``name``; with ``bwd``, of the
    VALID conv's input gradient, which takes (cotangent, OIHW weight): in
    a tree without ``conv3x3_valid_dx`` (the parent's, in compare_parent)
    what its backward ran, the cotangent padded by 2 and the VALID call
    with the flipped, channel-transposed weight."""
    import importlib

    mod = importlib.import_module(f"biasgan_tpu_torch.kernels.{name}")
    if not bwd:
        return getattr(mod, name), getattr(mod, name + "_plain")
    if hasattr(mod, "conv3x3_valid_dx"):
        return mod.conv3x3_valid_dx, mod.conv3x3_valid_dx_plain
    import torch.nn.functional as F

    def padded(fn):
        return lambda g, w: fn(F.pad(g, (0, 0, 2, 2, 2, 2)), w.flip(2, 3).transpose(0, 1))
    return padded(mod.conv3x3_valid), padded(mod.conv3x3_valid_plain)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def environment(torch) -> None:
    print(card())
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
    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        paths = dict(zip(build.SOURCES, pool.map(build.build, build.SOURCES)))
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
        # ptxas's notes where it serialized a kernel's wgmmas (C75xx)
        for note in sorted(set(re.findall(r"C75\d\d[^\n]*", log))):
            print(f"    ptxas: {note[:160]}")
    # the bf16 kernels run on wgmma and TMA: their machine code says so
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    for name, fns in WGMMA_KERNELS.items():
        sass = subprocess.run([cuobjdump, "--dump-sass", paths[name]], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        for fn, stores in fns.items():
            body = "".join(f for f in re.split(r"\n\s*Function : ", sass) if fn in f)
            ops = {op: len(re.findall(rf"\b{op}\b", body))
                   for op in ("HGMMA", "UTMALDG") + (("UTMASTG",) if stores else ())}
            print(f"  {name} bf16 kernel {fn} (cuobjdump --dump-sass): {ops}")
            check(all(ops.values()), f"{name} bf16 kernel {fn} lacks wgmma or TMA "
                  f"instructions: {ops}")


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
        halo = opt.get("w_mode") == "halo"  # x carries its 2 W pad columns
        x = _randn(torch, g, (n, h, w + 2 * halo, c)).to(dtype)
        if opt.get("halo_edge") == "wrap":  # the columns a periodic ring brings
            x[:, :, 0], x[:, :, -1] = x[:, :, -2].clone(), x[:, :, 1].clone()
        elif opt.get("halo_edge") == "zero":  # a non-periodic global edge
            x[:, :, 0] = x[:, :, -1] = 0
        wt = _randn(torch, g, (cout, c, 3, 3), (9 * c) ** -0.5).to(dtype)
        bias = _randn(torch, g, (cout,), 0.1)
        p = _prologue(torch, g, n, c) if pro else None
        if name == "conv3x3_fused":
            args = (x, wt, bias, p, "relu", opt.get("h_mode", "reflect"),
                    opt.get("w_mode", "wrap"), True)
            out_px = n * h * w
            lib = lambda: F.conv2d(x.permute(0, 3, 1, 2), wt, bias.to(dtype),
                                   padding=(1, 0) if halo else 1)
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
        nbytes = ((x.numel() + out_px * cout + 9 * c * cout) * es + 4 * cout
                  + (8 * n * c if pro else 0) + 8 * n * cout)
    elif name == "conv3x3_valid" and opt.get("bwd"):
        # the input gradient: the cotangent (n, h, w, Cout) of the forward
        # (C -> Cout) through the flipped, channel-transposed weight to
        # (n, h + 2, w + 2, C); the products the zero pad does not null:
        # each cotangent pixel through the 9 taps
        n, h, w, c, cout = shape
        gy = _randn(torch, g, (n, h, w, cout)).to(dtype)
        wt = _randn(torch, g, (cout, c, 3, 3), (9 * c) ** -0.5).to(dtype)
        args = (gy, wt)
        flops = 2 * n * h * w * 9 * c * cout
        nbytes = (n * h * w * cout + n * (h + 2) * (w + 2) * c + 9 * c * cout) * es
        lib = lambda: F.conv_transpose2d(gy.permute(0, 3, 1, 2), wt)
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


def hold(torch, name, args, where: str, fns=None):
    """The kernel against its plain version on the same inputs (``fns``:
    another (wrapper, plain version) pair of kernel ``name``'s library);
    returns max |dy| and, for kernels with moments, the stored-value
    moment ratio."""
    fn, plain = fns or kernel_fns(name)
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


def path_launches(name: str) -> int:
    """The launches so far on kernel ``name``'s bf16 path (PATH_COUNTERS),
    or 0 for a kernel with one path."""
    attr = PATH_COUNTERS.get(name)
    return getattr(kernel_fns(name)[0], attr) if attr else 0


def path_taken(name: str, before: int, dtype, where: str) -> str:
    """Check that the call since ``before`` took the bf16 path exactly when
    x was bf16; returns the words to print ('' for a kernel with one path)."""
    if name not in PATH_COUNTERS:
        return ""
    bf16 = str(dtype) == "torch.bfloat16"
    moved = path_launches(name) - before
    check(moved == int(bf16), f"{name} {where}: {moved} launches on the bf16 path")
    return ", path: TMA / wgmma kernel" if bf16 else ", path: f32 CUDA-core kernel"


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
    # gradient (conv3x3_valid_dx of the (B, 64, 64, 256) cotangent); calls
    # per step; and, 0 per step, the served --pallas_conv path's globe
    # block conv (18 per field)
    "conv3x3_valid": [((b, 66, 66, 256, 256), {}, 18) for b in (2, 3, 1)]
    + [((b, 64, 64, 256, 256), dict(bwd=True), 18) for b in (2, 3, 1)]
    + [((1, 183, 362, 256, 256), dict(bias=True), 0)],
}
# what each kernel's calls above are counted per
PER_UNIT = {name: "field" for name in GLOBE_CALLS}
PER_UNIT["conv3x3_valid"] = "step"
# the block convs of the sharded --fused_blocks path, per field per rank:
# the halo W mode at the block shape of a 4-way shard (W 1440 / 4 / 4 = 90)
SPATIAL_CALLS = {
    "conv3x3_fused": [((1, 181, 90, 256, 256), dict(prologue=True, w_mode="halo"), 18)],
}
# shapes held besides the main path's: the sharded path's halo-mode block
# conv, and the VALID conv's input gradient at the globe block shape
EXTRA_CHECKS = {
    "conv3x3_valid": [((1, 181, 360, 256, 256), dict(bwd=True))],
    "conv3x3_fused": [(shape, opt) for shape, opt, _ in SPATIAL_CALLS["conv3x3_fused"]],
}


def sweep_cases(name):
    """Small odd shapes over the modes each kernel takes."""
    if name == "conv3x3_fused":
        i = 0
        for c, cout in ((3, 5), (32, 48), (256, 256)):
            for h_mode in PAD_MODES:
                for w_mode in PAD_MODES + ("halo",):
                    yield (2, 13, 37, c, cout), dict(prologue=i % 2 == 1, h_mode=h_mode,
                                                     w_mode=w_mode)
                    i += 1
        # tiles of the bf16 kernel (7 x 18 pixels) touching both edges at
        # once, so both pad rows and columns and the four corners, in every
        # mode pair: C 12 and Cout 20 the wrapper pads; 7 x 18 fits the tile
        # exactly (Cout 136: two 128-cout tiles, the second ragged)
        for h_mode in PAD_MODES:
            for w_mode in PAD_MODES + ("halo",):
                for pro in (False, True):
                    yield (2, 5, 9, 12, 20), dict(prologue=pro, h_mode=h_mode, w_mode=w_mode)
                yield (1, 7, 18, 64, 136), dict(prologue=True, h_mode=h_mode, w_mode=w_mode)
        # batch 2 with 117 tiles per image, more than the card's SMs: blocks
        # of the persistent grid walk from one image into the next (a and b
        # and the moment slots change image), 128- and 256-cout tiles
        for c, cout in ((64, 128), (256, 256)):
            for h_mode, w_mode, pro in (("reflect", "wrap", True), ("zero", "halo", False),
                                        ("wrap", "reflect", True)):
                yield (2, 90, 150, c, cout), dict(prologue=pro, h_mode=h_mode, w_mode=w_mode)
    elif name in ("conv3x3s2_fused", "convt3x3s2_fused"):
        h, w = (26, 38) if name == "conv3x3s2_fused" else (13, 19)
        shapes = [(2, h, w, c, cout) for c, cout in ((3, 5), (64, 128), (256, 64))]
        if name == "conv3x3s2_fused":
            # batch 2 with 135 tiles per image, more than the card's SMs:
            # blocks of the bf16 kernel's persistent grid walk from one image
            # into the next (its prologue table and moment slots change image)
            shapes += [(2, 90, 600, 64, 128), (2, 90, 600, 128, 256)]
        else:
            # tiles of the bf16 kernel (7 x 18 input pixels) touching all four
            # edges (C 12 and Cout 20 the wrapper pads), three cout blocks
            # over ragged tiles (Cout 136), W narrower than a tile, a tile
            # filled exactly; batch 2 with 221 tiles per image, more units
            # than the card's SMs, so blocks walk into the next image (a and
            # b and the moment slots change image), one and two cout blocks
            shapes += [(2, 5, 9, 12, 20), (1, 13, 40, 64, 136), (2, 9, 16, 128, 64),
                       (1, 7, 18, 256, 64), (2, 90, 300, 64, 128), (2, 90, 300, 128, 64)]
        for shape in shapes:
            for w_mode in ("wrap", "zero"):
                for pro in (False, True):
                    yield shape, dict(prologue=pro, w_mode=w_mode)
    elif name == "conv7x7":
        for c, cout in ((1, 5), (3, 64), (8, 16), (64, 3), (9, 8), (24, 1)):
            yield (2, 19, 41, c, cout), {}
        # the bf16 kernels' edges (shapes are the padded input's): one 8 x 64
        # stem tile or 64-column head unit touching all four edges (5 x 9
        # outputs), every side test_torch_port_conv7_tiles.py takes (Cout
        # 136: three 64-cout stem launches, the last ragged; C 72: two
        # channel blocks; C 9 padded to 16); 2 x 2 ragged stem tiles and
        # two head strips (13 x 70); batch 2 with 240 stem tiles, more
        # than the card's SMs, and head units of one row each in two rounds
        # of the grid's 396 warpgroups (200 strips an image)
        for c in (1, 3, 8):
            for cout in (5, 64, 136):
                yield (2, 11, 15, c, cout), {}
        for cout in (1, 3, 8):
            for c in (9, 64, 72):
                yield (2, 11, 15, c, cout), {}
        for c, cout in ((3, 64), (8, 136), (64, 3), (72, 8)):
            yield (1, 19, 76, c, cout), {}
        yield (2, 96, 606, 3, 64), {}
        yield (2, 7, 12806, 64, 3), {}
    elif name == "conv3x3_valid":
        epilogues = [dict(act=act, bias=bias, residual=res) for act in ("none", "relu", "lrelu")
                     for bias, res in ((False, False), (True, False), (True, True), (False, True))]
        for c, cout in ((3, 5), (32, 48), (256, 256)):
            for opt in epilogues:
                yield (2, 15, 39, c, cout), opt
        # tiles of the bf16 kernel (7 x 18 pixels) touching both edges of the
        # output at once (5 x 9: C 12 and Cout 20 the wrapper pads), and
        # filling it exactly (Cout 136: two 128-cout tiles, the second
        # ragged), every epilogue
        for shape in ((2, 7, 11, 12, 20), (1, 9, 20, 64, 136)):
            for opt in epilogues:
                yield shape, opt
        # batch 2 with 117 tiles per image, more than the card's SMs: blocks
        # of the persistent grid walk from one image into the next, the
        # residual's TMA loads with them; 128- and 256-cout tiles
        for c, cout in ((64, 128), (256, 256)):
            for opt in (epilogues[4], epilogues[0], epilogues[11]):
                yield (2, 92, 152, c, cout), opt
        # the input gradient (the kernel's pad of 2 on the unpadded
        # cotangent (n, h, w, Cout), the taps reversed): tiles touching both
        # edges with C 12 and Cout 20 padded, an exact tile with Cout 136,
        # ragged tiles, batch 2 with more tiles than SMs
        for shape in ((2, 3, 7, 12, 20), (1, 5, 16, 64, 136), (2, 13, 37, 3, 5),
                      (2, 13, 37, 32, 48), (2, 88, 148, 64, 128)):
            yield shape, dict(bwd=True)
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
                before = path_launches(name)
                err, ratio = hold(torch, name, args, where, kernel_fns(name, opt.get("bwd")))
                print(f"{name} {where}: max|dy| {err:.3g}"
                      + (f", moments at {ratio:.3g} of the stored-value bound" if ratio else "")
                      + path_taken(name, before, dtype, where))
                if dtype == torch.bfloat16:
                    errs[name] = max(errs[name], err)
        n_cases, worst = 0, 0.0
        for shape, opt in sweep_cases(name):
            for dtype in (torch.bfloat16, torch.float32):
                args = make_case(torch, g, name, shape, dtype, **opt)[0]
                where = f"{shape} {dtype} {opt}"
                before = path_launches(name)
                worst = max(worst, hold(torch, name, args, where,
                                        kernel_fns(name, opt.get("bwd")))[1])
                path_taken(name, before, dtype, where)
                n_cases += 1
        print(f"{name} sweep: {n_cases} cases within tolerance"
              + (f"; moments at most {worst:.3g} of the stored-value bound" if worst else ""))
    return errs


def norm_path_cases():
    """(shape, options) of check_norm_paths: the sweep (C 5, 64, 264, every
    act with and without the residual), C 56 (a ragged last channel block on
    the persistent path, 7 of 8-channel groups) likewise, the globe's
    shapes and the training step's."""
    cases = list(sweep_cases("instance_norm_act"))
    cases += [((2, 13, 37, 56), dict(act=act, residual=res)) for act in ("none", "relu", "lrelu")
              for res in (False, True)]
    cases += [(shape, opt) for shape, opt, _ in GLOBE_CALLS["instance_norm_act"]]
    return cases + [(shape, opt) for shape, opt, _ in GRAD_CALLS["instance_norm_act"][1]]


def check_norm_paths(torch) -> dict:
    """The instance norm's forward (instance_norm_act) on each of its paths
    against instance_norm_act_plain (TOL) and its statistics against
    instance_norm_stats_plain (the mean within 1e-3 of the plane's |mean| +
    std, 1/std within 1e-3 relative), at norm_path_cases' shapes in f32 and
    bf16: on the path the plan names and, where that is the cluster path,
    on the persistent one too (persistent=True; the globe's planes fit no
    cluster); each call twice on one input, y and the statistics bitwise
    equal, each launch counted on its path. Returns the cases per path and
    the largest bf16 |dy|."""
    from biasgan_tpu_torch.kernels import instance_norm_act as k7

    g = torch.Generator(device="cuda").manual_seed(9)
    out = {"cases": {path: 0 for path in NORM_PATHS}, "max_abs_err": 0.0}
    for shape, opt in norm_path_cases():
        for dtype in (torch.bfloat16, torch.float32):
            x, r, act = make_case(torch, g, "instance_norm_act", shape, dtype, **opt)[0]
            rmean, rinv = k7.instance_norm_stats_plain(x)
            named = norm_path(shape, dtype)
            for persistent in ((False, True) if named == "cluster" else (False,)):
                path = "persistent" if persistent else named
                where = f"instance_norm_act {shape} {dtype} {opt} on the {path} path"
                before = {p: getattr(k7.instance_norm_act, f"{p}_launches") for p in NORM_PATHS}
                stats = [torch.empty((2, shape[0], shape[3]), device="cuda") for _ in range(2)]
                ys = [k7._launch(x, r, act, 1e-5, st, persistent) for st in stats]
                torch.cuda.synchronize()
                moved = {p: getattr(k7.instance_norm_act, f"{p}_launches") - before[p]
                         for p in NORM_PATHS}
                check(moved == {p: 2 * (p == path) for p in NORM_PATHS},
                      f"{where}: launches per path {moved}")
                err, _ = hold(torch, "instance_norm_act", (x, r, act), where,
                              (lambda *a: ys[0], k7.instance_norm_act_plain))
                mean, inv = stats[0]
                check(bool(((mean - rmean).abs() <= 1e-3 * (rmean.abs() + 1 / rinv)).all())
                      and bool(((inv - rinv).abs() <= 1e-3 * rinv).all()),
                      f"{where}: statistics off by {float((mean - rmean).abs().max()):.3g} "
                      f"(mean), {float(((inv - rinv) / rinv).abs().max()):.3g} (1/std, relative)")
                check(torch.equal(ys[0], ys[1]) and torch.equal(stats[0], stats[1]),
                      f"{where}: two calls on one input differ")
                out["cases"][path] += 1
                if dtype == torch.bfloat16:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
    print(f"instance_norm_act on both paths: {out['cases']} cases within tolerance, statistics "
          f"within 1e-3, every call twice bitwise equal, each launch on its path; bf16 largest "
          f"|dy| {out['max_abs_err']:.3g}")
    return out


def time_kernels(torch, shapes=GLOBE_CALLS) -> dict:
    """At each of a kernel's ``shapes`` (the globe shapes) in bf16: the
    kernel, its plain version and the library call, in turns (plain,
    library, kernel, kernel, library, plain), CUDA events over 20 calls
    each after 3 warm-up calls, best of each; and the bound. Per kernel,
    the per-field sums (each shape's time times its calls per field) and
    the per-shape numbers."""
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, kernel_calls in shapes.items():
        calls = []
        for shape, opt, count in kernel_calls:
            fn, plain = kernel_fns(name, opt.get("bwd"))
            args, nbytes, op_s, lib = make_case(torch, g, name, shape, torch.bfloat16, **opt)
            fns = {"plain": lambda: plain(*args), "library": lib, "kernel": lambda: fn(*args)}
            runs = {k: [] for k in fns}
            for which in ("plain", "library", "kernel", "kernel", "library", "plain"):
                runs[which].append(timed(torch, fns[which]))
            best = {k: min(v) for k, v in runs.items()}
            byte_ms, op_ms = nbytes / PEAK_BYTES * 1e3, op_s * 1e3
            device = device_time(torch, fns["kernel"])
            calls.append({
                "shape": list(shape), "options": opt, "count": count,
                "ms": best["kernel"], "plain_ms": best["plain"],
                "library_ms": best["library"], "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "bytes_ms": byte_ms, "operations_ms": op_ms,
                "device_ms": sum(device.values()), "device_ms_by_kernel": device,
            })
            print(f"{name} {shape} bf16 {opt}, ms per call (in turns): "
                  + "; ".join(f"{k} {v}" for k, v in runs.items())
                  + f"; bound {max(byte_ms, op_ms):.4f} ms ({calls[-1]['bound_by']})"
                  + f"; the kernel call's device ms (torch.profiler) "
                  f"{sum(device.values()):.4f}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in device.items()))
        fwd = [c for c in calls if not c["options"].get("bwd")]
        total = {k: sum(c[k] * c["count"] for c in fwd)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                           "operations_ms")}
        total["bound_by"] = "bytes" if total["bytes_ms"] >= total["operations_ms"] else "operations"
        bwd = [c for c in calls if c["options"].get("bwd")]
        if bwd:  # the VALID conv's input-gradient launches
            total.update({f"bwd_kernel_{k}": sum(c[k] * c["count"] for c in bwd)
                          for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")})
        total["calls"] = calls
        out[name] = total
    return out


def device_time(torch, fn, iters=10) -> dict:
    """ms per call of ``fn`` on the card by kernel name (the first 48
    characters), from torch.profiler over ``iters`` calls after a warm-up:
    what the card ran, apart from the host work of the call (the CUDA-event
    time includes the host's when it is the slower)."""
    return profile_calls(torch, fn, iters)[0]


def _kernel_events(torch, prof) -> list:
    """The profile's kernels on the card (copies and fills apart)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def profile_calls(torch, fn, iters=10):
    """(``device_time``'s ms per call by kernel, the number of kernel
    events the profile of ``iters`` calls holds)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    events = _kernel_events(torch, prof)
    for e in events:
        k = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)[:48]
        out[k] = out.get(k, 0.0) + e.device_time_total / 1e3 / iters
    return dict(sorted(out.items(), key=lambda kv: -kv[1])), len(events)


def counted_device_time(torch, fn, iters=10) -> dict:
    """``device_time`` with a check of the profile: the kernels one call
    runs on the card (a profile of one call after a warm-up, at least the
    port's kernel launches the call counts), and the events of the ``iters``
    timed calls, which must be ``iters`` times that many. torch.profiler
    has lost or doubled a call's events in some profiles, which then read a
    device time that was not the card's; such a reading is marked
    invalid."""
    from biasgan_tpu_torch.kernels import launch_counts

    def launches():  # the wrappers' launches (their per-path counts apart)
        return sum(v for k, v in launch_counts().items() if "." not in k)

    before = launches()
    per_call = device_kernels(torch, fn)[0]
    launched = (launches() - before) // 2  # the warm-up call and the profiled one
    by_kernel, events = profile_calls(torch, fn, iters)
    valid = per_call >= max(launched, 1) and events == iters * per_call
    return {"device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel,
            "kernels_per_call": per_call, "launches_per_call": launched,
            "events": events, "expected_events": iters * per_call, "device_valid": valid}


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


# The parent commit's tree, where one is unpacked there (git archive into a
# directory that .gitignore lists): compare_parent times, in both trees in
# turns, the kernels of COMPARE_KERNELS at their globe shapes and the
# sharded paths (the halo exchange at every shape of HALO_CALLS, the plain
# ring, the served ms/field). A plain checkout has none.
PARENT_TREE = os.path.join(HERE, ".chip_archive", "parent")
# timed in both trees (kernel_turn)
COMPARE_KERNELS = ("conv3x3_fused", "conv3x3_valid", "conv7x7", "convt3x3s2_fused",
                   "instance_norm_act")
COMPARE_ROUNDS = 1  # of the turns this, parent, parent, this
SHARDED_PATHS = ("spatial", "spatial_rdma", "spatial_rdma_fused")
# the shapes kernel_turn times a kernel at: its globe shapes and, for the
# block conv, the sharded path's halo W mode and the training step's
# forwards (with the prologue at B 2, 3, 1; without it at B 2); for the 7x7
# conv, the training step's stems and heads (B 2, 3, 1); for the instance
# norm, the training step's shapes too (GRAD_CALLS, added below it)
TURN_CALLS = {name: [(shape, opt) for shape, opt, _ in calls]
              for name, calls in GLOBE_CALLS.items()}
TURN_CALLS["conv3x3_fused"] += (
    [(shape, opt) for shape, opt, _ in SPATIAL_CALLS["conv3x3_fused"]]
    + [((b, 64, 64, 256, 256), dict(prologue=True)) for b in (2, 3, 1)]
    + [((2, 64, 64, 256, 256), dict(prologue=False))])
TURN_CALLS["conv7x7"] += [((b, 262, 262, c, cout), {}) for c, cout in ((3, 64), (64, 3))
                          for b in (2, 3, 1)]
# the block conv's backward called directly in the turns (bwd_case: H reflect,
# the prologue with ReLU, the moments' cotangents, a bias): the training
# step's three shapes and the sharded step's halo W mode
BWD_TURN_CALLS = ([((b, 64, 64, 256, 256), "wrap") for b in (2, 3, 1)]
                  + [((2, 64, 16, 256, 256), "halo-wrap")])
HOST_CALLS, HOST_RUNS = 20, 5  # a wrapper's host time: runs of calls back to back


def host_us(torch, fn) -> float:
    """us of host time a call of ``fn``: the host clock around HOST_CALLS
    calls issued back to back after a synchronize (the card idle at the
    first), with no synchronize between them; the best of HOST_RUNS runs
    (the host's clock varies more than the card's)."""
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


def kernel_turn(torch) -> dict:
    """One turn of compare_parent, in the tree this process imports the
    port from: each COMPARE_KERNELS kernel at its TURN_CALLS shapes in bf16
    on seeded inputs, ms per call (best of three timed runs) and the call's
    device ms by kernel, with the profile's check (``counted_device_time``);
    and the block conv's backward at BWD_TURN_CALLS, with its checked
    profile retried (``checked_device_time``) and its host us a call."""
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name in COMPARE_KERNELS:
        for shape, opt in TURN_CALLS[name]:
            fn = kernel_fns(name, opt.get("bwd"))[0]
            args = make_case(torch, g, name, shape, torch.bfloat16, **opt)[0]
            ms = min(timed(torch, lambda: fn(*args)) for _ in range(3))
            key = f"{name} {tuple(shape)}" + "".join(f" {k}={v}" for k, v in opt.items())
            out[key] = {"ms": ms, **counted_device_time(torch, lambda: fn(*args))}
    from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused_bwd

    for shape, w_mode in BWD_TURN_CALLS:
        args = bwd_case(torch, g, shape, torch.bfloat16, "reflect", w_mode, BWD_VARIANTS[0])
        ms = min(timed(torch, lambda: conv3x3_fused_bwd(*args)) for _ in range(3))
        out[f"conv3x3_fused_bwd {tuple(shape)} {w_mode}"] = {
            "ms": ms, **checked_device_time(torch, lambda: conv3x3_fused_bwd(*args), iters=10),
            "host_us": host_us(torch, lambda: conv3x3_fused_bwd(*args))}
    return out


def halo_turn_rank(rank, n, device, say, calls):
    """One rank of a sharded turn (``parallel.spawn``), through the API
    both trees have: at each exchange shape on the periodic ring, in turns,
    the halo kernel's exchange and the plain ring, each back to back on
    every rank under one closing sync (host clock). Returns rank 0's
    rows."""
    import torch
    import torch.distributed as dist

    from biasgan_tpu_torch.kernels import halo_exchange as hx
    from biasgan_tpu_torch.parallel import HaloCtx

    g = torch.Generator(device=device).manual_seed(100 + rank)
    ctx = HaloCtx(n, True, rdma=True)
    rows = []
    for shape, dt, left, right, count in calls:
        x = torch.randn(shape, generator=g, device=device).to(getattr(torch, dt))
        fns = {"exchange": lambda: hx.halo_exchange_w(x, left, right, ctx.ring),
               "plain": lambda: hx.halo_exchange_w_plain(x, left, right, ctx.ring)}
        runs = {k: [] for k in fns}
        for which in ("exchange", "plain", "plain", "exchange"):
            runs[which].append(_host_ms(torch, dist, fns[which]))
        rows.append({"shape": list(shape), "dtype": dt, "left": left, "right": right,
                     "count": count, **{k + "_ms": min(v) for k, v in runs.items()}})
    ctx.close()
    return rows


def sharded_turn(torch, work: str) -> dict:
    """The sharded part of a turn: halo_turn_rank on N_RANKS spawned ranks,
    per forward per rank; and the served ms/field of SHARDED_PATHS over the
    store in ``work`` (infer.main)."""
    from biasgan_tpu_torch import infer
    from biasgan_tpu_torch.parallel import spawn

    rows = spawn(halo_turn_rank, N_RANKS, (halo_call_shapes(),), device="cuda", timeout=600,
                 group_timeout=300)
    totals = halo_totals(rows, ("exchange_ms", "plain_ms"))
    served = {}
    for path in SHARDED_PATHS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            infer.main(serve_argv(work, path))
        served[path] = [float(v) for v in re.findall(r"corrected in ([0-9.]+) ms",
                                                     out.getvalue())]
    return {"halo": {p: {k: v for k, v in t.items() if k != "calls"}
                     for p, t in totals.items()}, "served_ms": served}


def parent_turn(torch, work: str) -> dict:
    """One turn of compare_parent, in the tree this process imports the
    port from."""
    return {"kernels": kernel_turn(torch), "sharded": sharded_turn(torch, work)}


def compare_parent(torch, work: str) -> dict:
    """This tree against PARENT_TREE, if it is there: each turn a fresh
    process that imports the port from one tree and runs this file's
    parent_turn (a copy of it under ``work``, which the turn's spawned ranks
    import), so both sides see the same inputs and timing; the store and
    checkpoint of ``work`` serve the sharded paths. Returns each side's
    best: per kernel shape its ms and device ms, the latter over the turns
    whose profile held the kernel events the calls make (the others are
    printed as dropped and counted; a side with no such turn reads None);
    per sharded path the halo
    exchange and plain ring per forward per rank, and the served ms/field
    (the median of fields 2..N of a turn) ({} without a parent tree)."""
    if not os.path.isdir(os.path.join(PARENT_TREE, "biasgan_tpu_torch")):
        print(f"parent comparison: skipped, no parent tree in {PARENT_TREE}")
        return {}
    t0 = time.perf_counter()
    turn_dir = os.path.join(work, "turn")
    os.makedirs(turn_dir, exist_ok=True)
    shutil.copy(os.path.abspath(__file__), os.path.join(turn_dir, "smoke_turn.py"))
    trees = {"this": HERE, "parent": PARENT_TREE}
    best = {"kernels": {}, "sharded": {}}
    torch.cuda.empty_cache()
    for _ in range(COMPARE_ROUNDS):
        for side in ("this", "parent", "parent", "this"):
            code = ("import json, sys\n"
                    f"sys.path[:0] = [{trees[side]!r}, {turn_dir!r}]\n"
                    "import torch, smoke_turn\n"
                    f"print('RESULT ' + json.dumps(smoke_turn.parent_turn(torch, {work!r})))\n")
            proc = subprocess.run([sys.executable, "-c", code], cwd=trees[side],
                                  capture_output=True, text=True, timeout=900)
            line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")),
                        None)
            check(proc.returncode == 0 and line is not None,
                  f"parent comparison: the {side} turn failed ({proc.returncode}): "
                  f"{proc.stderr[-2000:]}")
            turn = json.loads(line[len("RESULT "):])
            for key, r in turn["kernels"].items():
                print(f"  {side:6s} {key}: {r['ms']:.4f} ms per call (CUDA events), "
                      + (f"{r['device_ms']:.4f}" if r["device_ms"] is not None else "-")
                      + " on the card (torch.profiler): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in r["device_ms_by_kernel"].items())
                      + (f"; host {r['host_us']:.1f} us a call" if "host_us" in r else "")
                      + ("" if r["device_valid"] else
                         f"; device reading DROPPED: {r['events']} kernel events in the "
                         f"profile, expected {r['expected_events']} ({r['kernels_per_call']} "
                         f"a call, the port's launches {r['launches_per_call']})"))
                b = best["kernels"].setdefault(key, {}).setdefault(
                    side, {"ms": r["ms"], "device_ms": None, "dropped_device_turns": 0})
                b["ms"] = min(b["ms"], r["ms"])
                if "host_us" in r:
                    b["host_us"] = min(b.get("host_us", r["host_us"]), r["host_us"])
                    if r["device_valid"] and (b["device_ms"] is None
                                              or r["device_ms"] < b["device_ms"]):
                        b["device_ms_by_kernel"] = r["device_ms_by_kernel"]
                if not r["device_valid"]:
                    b["dropped_device_turns"] += 1
                elif b["device_ms"] is None or r["device_ms"] < b["device_ms"]:
                    b["device_ms"] = r["device_ms"]
            sh = turn["sharded"]
            mine = best["sharded"].setdefault(side, {})
            for path in SHARDED_PATHS:
                vals = {"served_ms": statistics.median(sh["served_ms"][path][1:])}
                if path in sh["halo"]:
                    vals.update(sh["halo"][path])
                print(f"  {side:6s} {path}: served ms/field {sh['served_ms'][path]}"
                      + "".join(f", halo {k} per forward per rank {v:.4f}"
                                for k, v in sh["halo"].get(path, {}).items()))
                b = mine.setdefault(path, vals)
                for k, v in vals.items():
                    b[k] = min(b[k], v)
    print(f"parent comparison, best of {2 * COMPARE_ROUNDS} turns a side "
          f"({torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s), "
          f"{time.perf_counter() - t0:.1f} s): {json.dumps(best)}")
    return best


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
# batch 1 on the route that runs it: (make_case shape, options, count)); the
# block conv's halo W mode per rank of the --spatial_mesh 4 --fused_blocks
# step (W 64 / 4 = 16 per shard)
GRAD_CALLS = {
    "conv3x3_fused_t": ("conv3x3_fused", [((b, 64, 64, 256, 256), dict(prologue=True), 18)
                                          for b in (2, 3, 1)]),
    "conv3x3_fused_t_halo": ("conv3x3_fused", [
        ((b, 64, 16, 256, 256), dict(prologue=True, w_mode="halo", halo_edge="wrap"), 18)
        for b in (2, 3, 1)]),
    "conv3x3_op": ("conv3x3_valid", [((b, 66, 66, 256, 256), {}, 18) for b in (2, 3, 1)]),
    "conv7x7": ("conv7x7", [((b, 262, 262, 3, 64), {}, 1) for b in (2, 3, 1)]
                + [((b, 262, 262, 64, 3), {}, 1) for b in (2, 3, 1)]),
    "instance_norm_act": ("instance_norm_act", [
        (shape, dict(act=act), n) for shape, act, n in _in_norms((2, 3, 1), ((1, 2), (2, 2)))]),
}
TURN_CALLS["instance_norm_act"] += [(shape, opt) for shape, opt, _ in
                                     GRAD_CALLS["instance_norm_act"][1]]
# the instance norm's forward calls per served field or training step on the
# paths that run it: (NHWC shape, calls), each on the path its plan names
NORM_CALLS = {"plain_norm": [(shape, n) for shape, _, n in GLOBE_CALLS["instance_norm_act"]],
              "all": [(shape, n) for shape, _, n in GRAD_CALLS["instance_norm_act"][1]]}
# the shapes whose gradients are held to autograd through the plain version
GRAD_CHECKS = {
    "conv3x3_fused_t": [((2, 64, 64, 256, 256), dict(prologue=True)),
                        ((1, 64, 64, 256, 256), dict(prologue=False))],
    # the sharded step's shape, wrap and zero-edge, and ragged widths
    "conv3x3_fused_t_halo": [
        ((2, 64, 16, 256, 256), dict(prologue=True, w_mode="halo", halo_edge="wrap")),
        ((3, 64, 16, 256, 256), dict(prologue=False, w_mode="halo", halo_edge="zero")),
        ((1, 64, 16, 256, 256), dict(prologue=True, w_mode="halo", halo_edge="zero")),
        ((2, 13, 37, 32, 48), dict(prologue=True, w_mode="halo", halo_edge="wrap",
                                   h_mode="zero")),
        ((1, 9, 5, 256, 256), dict(prologue=False, w_mode="halo", halo_edge="zero"))],
    "conv3x3_op": [((2, 66, 66, 256, 256), {}), ((1, 15, 39, 32, 48), dict(bias=True)),
                   ((2, 7, 11, 12, 20), dict(bias=True)), ((1, 9, 20, 64, 136), {})],
    "conv7x7": [((1, 262, 262, 3, 64), {}), ((1, 262, 262, 64, 3), {})],
    "instance_norm_act": [((2, 64, 64, 256), dict(act="none", residual=True)),
                          ((1, 256, 256, 64), dict(act="relu")),
                          ((2, 31, 31, 512), dict(act="lrelu"))],
}
GRAD_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (0.05, 0.1)}  # (atol x max(1,|ref|), rtol)


def bwd_work(form, shape, opt, es, op_s):
    """(bytes, seconds of operations at the card's peak) of one call's
    backward: each of its inputs (the outputs' cotangents, and what it
    reads again: x, the weight, and for the fused conv its stored y) read
    once and each gradient written once; for a conv, the input and weight
    gradients' operations (twice the forward's), for the norm ~10 f32
    operations per element."""
    if form.startswith("conv3x3_fused_t") or form in ("conv3x3_op", "conv7x7"):
        n, h, w, c, cout = shape
        k = 7 if form == "conv7x7" else 3
        if form.startswith("conv3x3_fused_t"):
            x = n * h * (w + 2 * (opt.get("w_mode") == "halo")) * c
            out, reads_y = n * h * w * cout, True
        else:
            x, out, reads_y = n * h * w * c, n * (h - k + 1) * (w - k + 1) * cout, False
        wt = k * k * c * cout
        return (out * (1 + reads_y) + 2 * x + 2 * wt) * es, 2 * op_s
    numel = 1
    for d in shape:
        numel *= d
    return (3 + opt.get("residual", False)) * numel * es, 10 * numel / PEAK_FLOPS["float32"]


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
    if form.startswith("conv3x3_fused_t"):
        x, w, bias, pro, act, hm, wm, _ = leaves
        pro = tuple(t.detach().requires_grad_(True) for t in pro) if pro else None
        ins = [x, w, bias] + list(pro or ())

        def flat(out):
            y, (s, q) = out
            return [y, s, q]

        fn = lambda: flat(conv3x3_fused_t(x, w, bias, pro, act, hm, wm))
        plain = lambda: flat(conv3x3_fused_plain(x, w, bias, pro, act, hm, wm))
        lib = lambda: [F.conv2d(x.permute(0, 3, 1, 2), w, bias.to(dtype),
                                padding=(1, 0) if wm == "halo" else 1)]
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


# the fused block conv's backward kernel, held directly to its plain version
# (the torch-ops backward): ragged tiles, H = 2 (reflect's rows 1 and n-2 on
# the edges), a tiny W, the one-card training shape and the sharded one
BWD_SHAPES = [(2, 13, 37, 32, 48), (1, 9, 5, 256, 256), (2, 2, 17, 16, 24),
              (2, 64, 64, 256, 256), (3, 64, 16, 256, 256)]
BWD_W_MODES = ("wrap", "reflect", "zero", "halo-wrap", "halo-zero")
# (prologue, act, moments, bias): every act with the prologue, none without
BWD_VARIANTS = [(True, "relu", True, True), (True, "lrelu", False, True),
                (True, "none", True, False), (False, "relu", False, False)]


def bwd_case(torch, g, shape, dtype, h_mode, w_mode, variant):
    """The arguments of one ``conv3x3_fused_bwd`` call on random inputs and
    cotangents (halo-wrap / halo-zero: the halo W mode with the columns a
    periodic ring or a zero global edge brings)."""
    n, h, w, c, cout = shape
    pro, act, moments, bias = variant
    halo = w_mode.startswith("halo")
    x = _randn(torch, g, (n, h, w + 2 * halo, c))
    if w_mode == "halo-wrap":
        x[:, :, 0], x[:, :, -1] = x[:, :, -2].clone(), x[:, :, 1].clone()
    elif w_mode == "halo-zero":
        x[:, :, 0] = x[:, :, -1] = 0
    a, b = _prologue(torch, g, n, c) if pro else (None, None)
    return (x.to(dtype), _randn(torch, g, (cout, c, 3, 3), (9 * c) ** -0.5).to(dtype),
            _randn(torch, g, (cout,), 0.1) if bias else None, a, b,
            _randn(torch, g, (n, h, w, cout)).to(dtype),
            _randn(torch, g, (n, h, w, cout)).to(dtype),
            _randn(torch, g, (n, cout)) if moments else None,
            _randn(torch, g, (n, cout), 0.01) if moments else None,
            act, h_mode, "halo" if halo else w_mode)


def check_bwd_kernel(torch) -> dict:
    """``conv3x3_fused_bwd`` (the kernel) against ``conv3x3_fused_bwd_plain``
    on the same arguments: every shape of BWD_SHAPES with every H pad and W
    mode, the variants in turn (at the training shapes all of them for the
    training routes' modes), f32 and bf16, under GRAD_TOL, one launch per
    call, each bf16 one on the TMA / wgmma kernels (``wgmma_launches``),
    and two calls on the same arguments bitwise equal. Returns the largest
    |d| in bf16 (absolute, and relative to max(1, |ref|))."""
    from biasgan_tpu_torch.kernels.conv3x3_fused import (
        conv3x3_fused_bwd,
        conv3x3_fused_bwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(7)
    worst = {"max_abs_err": 0.0, "max_grad_err": 0.0}
    n_cases = 0
    for shape in BWD_SHAPES:
        i = 0
        for h_mode in PAD_MODES:
            for w_mode in BWD_W_MODES:
                variants = [BWD_VARIANTS[i % len(BWD_VARIANTS)]]
                i += 1
                if shape[1] == 64 and h_mode == "reflect" and w_mode in ("reflect", "halo-wrap"):
                    variants = BWD_VARIANTS
                for variant, dtype in ((v, d) for v in variants
                                       for d in (torch.bfloat16, torch.float32)):
                    args = bwd_case(torch, g, shape, dtype, h_mode, w_mode, variant)
                    before = (conv3x3_fused_bwd.launches, conv3x3_fused_bwd.wgmma_launches)
                    got = conv3x3_fused_bwd(*args)
                    again = conv3x3_fused_bwd(*args)
                    torch.cuda.synchronize()
                    bf16 = dtype == torch.bfloat16
                    check((conv3x3_fused_bwd.launches, conv3x3_fused_bwd.wgmma_launches)
                          == (before[0] + 2, before[1] + 2 * bf16),
                          "conv3x3_fused_bwd: not one launch per call, each bf16 one on the "
                          "TMA / wgmma kernels")
                    ref = conv3x3_fused_bwd_plain(*args)
                    atol, rtol = GRAD_TOL[str(dtype).replace("torch.", "")]
                    where = f"{shape} {dtype} {h_mode}/{w_mode} {variant}"
                    for name, a, b in zip(("dx", "dw", "dbias", "da", "db"), got, again):
                        check(a is None or torch.equal(a, b),
                              f"conv3x3_fused_bwd {where}: two calls' {name} differ")
                    for name, a, b in zip(("dx", "dw", "dbias", "da", "db"), got, ref):
                        check((a is None) == (b is None), f"conv3x3_fused_bwd {where}: {name}")
                        if a is None:
                            continue
                        check(a.dtype == b.dtype and a.shape == b.shape,
                              f"conv3x3_fused_bwd {where}: {name} dtype or shape")
                        a, b = a.float(), b.float()
                        scale = max(1.0, float(b.abs().max()))
                        d = float((a - b).abs().max())
                        check(bool(torch.isfinite(a).all()),
                              f"conv3x3_fused_bwd {where}: non-finite {name}")
                        check(bool(((a - b).abs() <= atol * scale + rtol * b.abs()).all()),
                              f"conv3x3_fused_bwd {where}: {name} off by {d / scale:.3g} of "
                              "max(1, |ref|)")
                        if dtype == torch.bfloat16:
                            worst["max_abs_err"] = max(worst["max_abs_err"], d)
                            worst["max_grad_err"] = max(worst["max_grad_err"], d / scale)
                    n_cases += 1
    print(f"conv3x3_fused_bwd: {n_cases} cases (kernel vs plain backward) within the "
          f"gradient bounds, two calls bitwise equal, every bf16 call on the TMA / wgmma "
          f"kernels; bf16 largest |d| {worst['max_abs_err']:.3g}, "
          f"{worst['max_grad_err']:.3g} of max(1, |ref|)")
    return worst


# the instance norm's backward kernel, held directly to its plain version:
# every training shape of the all-kernel route (with GRAD_CHECKS' K7 shapes
# among them), H W = 1, and C = 12 (not a multiple of 8)
NORM_BWD_SHAPES = sorted({s for s, _, _ in _in_norms((2, 3, 1), ((1, 2), (2, 2)))}
                         | {s for s, _ in GRAD_CHECKS["instance_norm_act"]}) + [
    (2, 1, 1, 8), (2, 13, 37, 12)]


def norm_bwd_args(torch, g, shape, dtype, act, residual):
    """The arguments of one ``instance_norm_act_bwd`` call as training makes
    them: x, the forward kernel's output and the statistics it saved for
    the backward (read from the autograd node), a random cotangent."""
    from biasgan_tpu_torch.kernels.instance_norm_act import instance_norm_act

    x = _randn(torch, g, shape, 3.0, 1.0).to(dtype)
    r = _randn(torch, g, shape).to(dtype) if residual else None
    y = instance_norm_act(x.requires_grad_(True), r, act)
    x, out, stats = y.grad_fn.saved_tensors
    return x.detach(), out.detach(), _randn(torch, g, shape).to(dtype), stats, act, residual


def norm_bwd_paths(torch, shape, dtype) -> list:
    """The kernel's paths at this shape: the one-launch cluster path where
    the plan takes it, and the two-pass path always."""
    from biasgan_tpu_torch.kernels.common import DTYPE_CODE, num_tiles

    n, h, w, c = shape
    cluster = num_tiles("instance_norm_act_bwd", "instance_norm_act_bwd_num_tiles", n, h * w,
                        c, DTYPE_CODE[dtype], 0) == 0
    return ([False] if cluster else []) + [True]


def check_norm_bwd_kernel(torch) -> dict:
    """``instance_norm_act_bwd`` (the kernel) against
    ``instance_norm_act_bwd_plain`` on the same arguments (the forward
    kernel's saved statistics among them): every shape of NORM_BWD_SHAPES,
    every act with and without a residual, f32 and bf16, on the one-launch
    cluster path where the shape takes it and on the two-pass path; dx
    under GRAD_TOL (exactly 0 at H W = 1), d_res bitwise, one launch per
    call. Returns the largest |d dx| in bf16 (absolute, and relative to
    max(1, |ref|))."""
    from biasgan_tpu_torch.kernels.instance_norm_act import (
        instance_norm_act_bwd,
        instance_norm_act_bwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(8)
    worst = {"max_abs_err": 0.0, "max_grad_err": 0.0}
    n_cases, cluster_shapes = 0, []
    for shape, dtype in ((s, d) for s in NORM_BWD_SHAPES
                         for d in (torch.bfloat16, torch.float32)):
        paths = norm_bwd_paths(torch, shape, dtype)
        if len(paths) == 2:
            cluster_shapes.append(f"{shape} {str(dtype)[6:]}")
        for act, residual, two_pass in ((a, r, t) for a in ("none", "relu", "lrelu")
                                        for r in (False, True) for t in paths):
            args = norm_bwd_args(torch, g, shape, dtype, act, residual)
            before = instance_norm_act_bwd.launches
            dx, d_res = instance_norm_act_bwd(*args, two_pass=two_pass)
            torch.cuda.synchronize()
            check(instance_norm_act_bwd.launches == before + 1,
                  "instance_norm_act_bwd: not one launch per call")
            rdx, rd_res = instance_norm_act_bwd_plain(*args)
            where = (f"instance_norm_act_bwd {shape} {dtype} {act} residual {residual} "
                     f"{'two-pass' if two_pass else 'cluster'}")
            check(dx.dtype == dtype and dx.shape == args[0].shape,
                  f"{where}: dx dtype or shape")
            a, b = dx.float(), rdx.float()
            scale = max(1.0, float(b.abs().max()))
            d = float((a - b).abs().max())
            atol, rtol = GRAD_TOL[str(dtype).replace("torch.", "")]
            check(bool(torch.isfinite(a).all()), f"{where}: non-finite dx")
            check(bool(((a - b).abs() <= atol * scale + rtol * b.abs()).all()),
                  f"{where}: dx off by {d / scale:.3g} of max(1, |ref|)")
            if shape[1] * shape[2] == 1:
                check(bool((dx == 0).all()), f"{where}: dx not 0 at H W = 1")
            check((d_res is None) == (not residual), f"{where}: d_res")
            if residual:
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                check(d_res.dtype == dtype and torch.equal(d_res.view(bits),
                                                           rd_res.view(bits)),
                      f"{where}: d_res not bitwise the plain version's")
            if dtype == torch.bfloat16:
                worst["max_abs_err"] = max(worst["max_abs_err"], d)
                worst["max_grad_err"] = max(worst["max_grad_err"], d / scale)
            n_cases += 1
    print(f"instance_norm_act_bwd: {n_cases} cases (kernel vs plain backward) within the "
          f"gradient bounds, d_res bitwise; bf16 largest |d| {worst['max_abs_err']:.3g}, "
          f"{worst['max_grad_err']:.3g} of max(1, |ref|); the cluster path and the two-pass "
          f"path both at {', '.join(cluster_shapes)}; the two-pass path alone elsewhere")
    return worst


def device_kernels(torch, fn):
    """(the kernels the card runs in one call of ``fn``, the sum of their
    device times in ms): torch.profiler, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.name.startswith(("Memcpy", "Memset"))]
    return len(ev), sum(e.device_time_total for e in ev) / 1e3


PROFILE_TRIES = 3  # profiles a checked reading takes at most


def checked_device_time(torch, fn, iters=5) -> dict:
    """``counted_device_time`` taken again, up to PROFILE_TRIES times, until
    its profile holds the kernel events the calls make; ``device_ms`` (and
    its split by kernel) reads None where no try did."""
    for tries in range(1, PROFILE_TRIES + 1):
        d = counted_device_time(torch, fn, iters)
        if d["device_valid"]:
            break
    if not d["device_valid"]:
        d.update(device_ms=None, device_ms_by_kernel={})
    return {**d, "tries": tries}


def in_fresh_process(fn: str, work: str):
    """``fn(torch)`` of this file run in a fresh process (a copy of this file
    under ``work``, the port imported from this tree, TF32 off, the same
    kernel builds), its JSON result back. torch.profiler has dropped a
    call's device events in every profile late in this script's long
    process; a fresh process's profiles hold them."""
    turn_dir = os.path.join(work, "turn")
    os.makedirs(turn_dir, exist_ok=True)
    shutil.copy(os.path.abspath(__file__), os.path.join(turn_dir, "smoke_turn.py"))
    code = ("import json, sys\n"
            f"sys.path[:0] = [{HERE!r}, {turn_dir!r}]\n"
            "import torch, smoke_turn\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            f"out = smoke_turn.{fn}(torch)\n"
            "print('RESULT ' + json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, capture_output=True,
                          text=True, timeout=900)
    print(proc.stdout[:proc.stdout.find("RESULT ")] if "RESULT " in proc.stdout
          else proc.stdout, end="")
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
    check(proc.returncode == 0 and line is not None,
          f"{fn} in a fresh process failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return json.loads(line[len("RESULT "):])


def time_grads(torch) -> dict:
    """At each training shape in bf16: the differentiable form's forward
    (autograd recording) and backward, beside cuDNN's (or the library
    norm's) through autograd, in turns, CUDA events, best of two; the
    plain version's forward; the forward bound. For the fused block conv
    and the instance norm also, in the same turns, the backward kernel
    called directly (``kernel_bwd``) and the old torch-ops backward
    (``plain_bwd``, the plain version at bf16), on the forward's output and
    saved arguments, and the device kernels of one backward on each, from
    checked profiles (``checked_device_time``: a profile that lost or
    doubled a call's kernel events is taken again; a reading none held is
    None, and so is its form's per-step sum). Per form, the per-step sums
    (each call's time times its count) and the per-call numbers; K2's
    backward called directly is printed by kernel."""
    from biasgan_tpu_torch.kernels.conv3x3_fused import (
        conv3x3_fused_bwd,
        conv3x3_fused_bwd_plain,
    )
    from biasgan_tpu_torch.kernels.instance_norm_act import (
        instance_norm_act_bwd,
        instance_norm_act_bwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for form, (_, calls) in GRAD_CALLS.items():
        rows = []
        fused = form.startswith("conv3x3_fused_t")
        direct = fused or form == "instance_norm_act"
        bwd_fn, bwd_plain = ((conv3x3_fused_bwd, conv3x3_fused_bwd_plain) if fused else
                             (instance_norm_act_bwd, instance_norm_act_bwd_plain))
        for shape, opt, count in calls:
            fn, plain, lib, ins, nbytes, op_s = grad_case(torch, g, form, shape,
                                                          torch.bfloat16, **opt)
            runs = {k: [] for k in ("fwd", "bwd", "library_fwd", "library_bwd", "kernel_bwd",
                                    "plain_bwd")}
            kernels, device_ms, by_kernel = {}, {}, {}

            def profiled(key, f):
                if key not in kernels:
                    d = checked_device_time(torch, f)
                    kernels[key], device_ms[key] = d["kernels_per_call"], d["device_ms"]
                    by_kernel[key] = d["device_ms_by_kernel"]

            for which, f in (("", fn), ("library_", lib), ("plain_", None), ("plain_", None),
                             ("library_", lib), ("", fn)):
                if which == "plain_":
                    if direct:
                        runs["plain_bwd"].append(timed(torch, lambda: bwd_plain(*bwd_args),
                                                       iters=10, warmup=2))
                        profiled("plain_bwd", lambda: bwd_plain(*bwd_args))
                    continue
                outs = f()
                cots = [torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
                        for o in outs]
                runs[which + "fwd"].append(timed(torch, f, iters=10, warmup=2))
                def grad():
                    return torch.autograd.grad(outs, ins, cots, retain_graph=True,
                                               allow_unused=True)

                runs[which + "bwd"].append(timed(torch, grad, iters=10, warmup=2))
                profiled(which + "bwd", grad)
                if fused and which == "":
                    # the backward's own arguments: the stored y and the cotangents
                    x, w, bias, *pro = ins
                    a, b = pro if pro else (None, None)
                    bwd_args = (x.detach(), w.detach(), bias.detach(),
                                None if a is None else a.detach(),
                                None if b is None else b.detach(), outs[0].detach(), *cots,
                                "relu", opt.get("h_mode", "reflect"), opt.get("w_mode", "wrap"))
                elif direct and which == "":
                    # x, the output and the statistics the forward saved
                    x, y, stats = outs[0].grad_fn.saved_tensors
                    bwd_args = (x.detach(), y.detach(), cots[0], stats, opt["act"],
                                opt.get("residual", False))
                if direct and which == "":
                    runs["kernel_bwd"].append(timed(torch, lambda: bwd_fn(*bwd_args),
                                                    iters=10, warmup=2))
                    profiled("kernel_bwd", lambda: bwd_fn(*bwd_args))
                del outs
            with torch.no_grad():
                plain_ms = timed(torch, plain, iters=5, warmup=1)
            best = {k: min(v) for k, v in runs.items() if v}
            byte_ms, op_ms = nbytes / PEAK_BYTES * 1e3, op_s * 1e3
            bwd_bytes, bwd_op_s = bwd_work(form, shape, opt, 2, op_s)
            bwd_bytes_ms, bwd_op_ms = bwd_bytes / PEAK_BYTES * 1e3, bwd_op_s * 1e3
            rows.append({"shape": list(shape), "options": opt, "count": count,
                         "ms": best["fwd"], "bwd_ms": best["bwd"], "plain_ms": plain_ms,
                         "library_ms": best["library_fwd"],
                         "library_bwd_ms": best["library_bwd"],
                         "bound_ms": max(byte_ms, op_ms), "bytes_ms": byte_ms,
                         "operations_ms": op_ms, "bwd_bound_ms": max(bwd_bytes_ms, bwd_op_ms),
                         "bwd_bytes_ms": bwd_bytes_ms, "bwd_operations_ms": bwd_op_ms,
                         "device_kernels_per_bwd": kernels,
                         "device_ms_per_bwd": device_ms,
                         "device_ms_per_bwd_by_kernel": by_kernel,
                         **({"kernel_bwd_ms": best["kernel_bwd"],
                             "plain_bwd_ms": best["plain_bwd"]} if direct else {})})
            print(f"{form} {shape} bf16 {opt} x{count}/step, ms per call (in turns): "
                  + "; ".join(f"{k} {v}" for k, v in runs.items() if v)
                  + f"; plain fwd {plain_ms:.4f}; fwd bound {max(byte_ms, op_ms):.4f}; bwd "
                  f"bound {max(bwd_bytes_ms, bwd_op_ms):.4f}; device kernels per backward "
                  f"{kernels}, their device ms {device_ms} (checked profiles)")
            if fused:
                print(f"  {form} {shape}: the backward kernel's device ms by kernel "
                      + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel["kernel_bwd"].items()))
        keys = ["ms", "bwd_ms", "plain_ms", "library_ms", "library_bwd_ms", "bound_ms",
                "bytes_ms", "operations_ms", "bwd_bound_ms", "bwd_bytes_ms",
                "bwd_operations_ms"] + (["kernel_bwd_ms", "plain_bwd_ms"] if direct else [])
        total = {k: sum(r[k] * r["count"] for r in rows) for k in keys}
        total["device_ms_per_step"] = {
            k: (None if any(r["device_ms_per_bwd"][k] is None for r in rows)
                else sum(r["device_ms_per_bwd"][k] * r["count"] for r in rows))
            for k in rows[0]["device_ms_per_bwd"]}
        if fused:
            by = total["kernel_bwd_device_ms_per_step_by_kernel"] = {}
            for r in rows:
                for k, v in r["device_ms_per_bwd_by_kernel"]["kernel_bwd"].items():
                    by[k] = by.get(k, 0.0) + v * r["count"]
        total["bound_by"] = "bytes" if total["bytes_ms"] >= total["operations_ms"] else "operations"
        total["bwd_bound_by"] = ("bytes" if total["bwd_bytes_ms"] >= total["bwd_operations_ms"]
                                 else "operations")
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


# ---------------------------------------------------------------------------
# The halo exchange and the sharded forward, inside N_RANKS spawned ranks
# ---------------------------------------------------------------------------

HALO_ITERS = 20  # with 2 warm-up launches: an even count keeps the ping-pong in step
LOOPBACK_ROUNDS = 64  # back-to-back exchanges per loopback case, fresh shards each
LOOPBACK_TIMED = 100  # back-to-back exchanges per loopback timing


def halo_call_shapes() -> list:
    """Every exchange shape of HALO_CALLS, once."""
    return list(dict.fromkeys(c for path in HALO_CALLS.values() for c in path))


def _host_ms(torch, dist, fn, iters=HALO_ITERS) -> float:
    """Host ms per call of ``fn`` on every rank at once: after a warm-up
    call and a barrier, ``iters`` calls back to back under one closing
    device sync."""
    fn()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def halo_rank(rank, n, device, say, calls):
    """One rank of the halo phase (``parallel.spawn``). At each exchange
    shape, periodic and zero-edge: the kernel's halos bitwise against the
    plain ring's (every rank's mismatches and largest |kernel - ring|
    gathered). Then on the periodic ring, in turns: the exchange (back to
    back on every rank under one closing sync, host clock: on the host
    route each exchange syncs and meets the ranks inside), its kernels
    (host route: CUDA events around rank 0's launches of the copy alone,
    the other ranks waiting, so no other process shares the card;
    signalled route, where a send waits on the neighbours' receives: the
    device time of an exchange's two kernels on every rank at once,
    torch.profiler), the plain ring (under gloo with host copies) and the
    ring's messages alone (under gloo the plain ring on host tensors;
    under NCCL it is the plain ring). Returns rank 0's timings, the route
    and every rank's exchange counts."""
    import torch
    import torch.distributed as dist

    from biasgan_tpu_torch.kernels import halo_exchange as hx
    from biasgan_tpu_torch.parallel import HaloCtx

    g = torch.Generator(device=device).manual_seed(100 + rank)
    xs = [torch.randn(shape, generator=g, device=device).to(getattr(torch, dt))
          for shape, dt, _, _, _ in calls]
    mismatches, err = [], 0.0
    for periodic in (True, False):
        ctx = HaloCtx(n, periodic, rdma=True)
        for x, (shape, dt, left, right, _) in zip(xs, calls):
            got = hx.halo_exchange_w(x, left, right, ctx.ring)
            ref = hx.halo_exchange_w_plain(x, left, right, ctx.ring)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                mismatches.append(f"rank {rank}: {shape} {dt} ({left},{right}) "
                                  f"periodic={periodic}")
            err = max([err] + [float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, ref) if a.numel()])
        ctx.close()
    every = [None] * n
    dist.all_gather_object(every, (mismatches, err))

    ctx = HaloCtx(n, True, rdma=True)
    rows = []
    for x, (shape, dt, left, right, count) in zip(xs, calls):
        xh = x.cpu() if ctx.ring.via_host else x  # gloo takes host tensors, NCCL device ones
        fns = {"plain": lambda: hx.halo_exchange_w_plain(x, left, right, ctx.ring),
               "library": lambda: hx.halo_exchange_w_plain(xh, left, right, ctx.ring),
               "exchange": lambda: hx.halo_exchange_w(x, left, right, ctx.ring)}
        runs = {k: [] for k in ("plain", "library", "exchange", "kernel")}
        for which in ("plain", "library", "exchange", "kernel", "kernel", "exchange",
                      "library", "plain"):
            if which != "kernel":
                runs[which].append(_host_ms(torch, dist, fns[which]))
            elif ctx.ring.route == "signalled":
                dist.barrier()
                runs["kernel"].append(sum(device_time(torch, fns["exchange"],
                                                      iters=HALO_ITERS).values()))
            else:
                dist.barrier()
                if rank == 0:
                    runs["kernel"].append(timed(
                        torch, lambda: hx.launch_halo_kernel(x, left, right, ctx.ring),
                        iters=HALO_ITERS, warmup=2))
                dist.barrier()
        moved = x.shape[0] * x.shape[1] * (left + right) * x.shape[3] * x.element_size()
        rows.append({
            "shape": list(shape), "dtype": dt, "left": left, "right": right, "count": count,
            "bytes": moved, **{k + "_ms": min(v) for k, v in runs.items() if v},
            "bound_ms": 2 * moved / PEAK_BYTES * 1e3, "nvlink_bound_ms": moved / NVLINK_BYTES * 1e3,
        })
    counts = [None] * n
    dist.all_gather_object(counts, hx.halo_counts(ctx.ring))
    ctx.close()
    return {"mismatches": [m for ms, _ in every for m in ms],
            "max_abs_err": max(e for _, e in every), "rows": rows, "backend": dist.get_backend(),
            "counts": counts}


def halo_totals(rows, keys) -> dict:
    """Per sharded path, each of ``keys`` of the per-shape ``rows`` times
    its exchanges per forward, summed: per forward per rank."""
    by_key = {(tuple(r["shape"]), r["dtype"], r["left"], r["right"]): r for r in rows}
    totals = {}
    for path, path_calls in HALO_CALLS.items():
        path_rows = [by_key[c[:4]] for c in path_calls]
        totals[path] = {k: sum(r[k] * r["count"] for r in path_rows) for k in keys}
        totals[path]["calls"] = path_rows
    return totals


def check_halo_exchange(torch) -> dict:
    """The halo phase on N_RANKS spawned ranks: every exchange shape of
    both sharded paths, the kernel bitwise against the plain ring, on the
    route the ranks' cards give (one card: host-synchronised; a card per
    rank: signalled, every exchange counted as such); the timings per
    shape, and per path the per-field sums (each shape's time times its
    exchanges per forward, per rank)."""
    from biasgan_tpu_torch.parallel import placement, spawn

    calls = halo_call_shapes()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(halo_rank, N_RANKS, (calls,), device="cuda", timeout=600, group_timeout=300)
    check(not res["mismatches"], "halo_exchange_w differs from the plain ring: "
          + "; ".join(res["mismatches"]))
    route = res["counts"][0]["route"]
    want = "signalled" if torch.cuda.device_count() >= N_RANKS else "host"
    check(all(c["route"] == want for c in res["counts"]),
          f"halo_exchange_w routes {[c['route'] for c in res['counts']]}, expected {want}")
    if want == "signalled":
        check(all(c["signalled"] == c["exchanges"] > 0 for c in res["counts"]),
              f"halo_exchange_w: not every exchange was signalled: {res['counts']}")
    print(f"halo_exchange_w: {placement(N_RANKS, 'cuda', True)}: {len(calls)} shapes x "
          f"periodic/zero-edge bitwise equal to the plain ring, route {route}, per rank "
          f"{json.dumps(res['counts'])} ({time.perf_counter() - t0:.1f} s)")
    name = torch.cuda.get_device_name(0)
    kernel = ("the two kernels on the card (torch.profiler)" if route == "signalled" else
              "the copy alone (CUDA events)")
    for r in res["rows"]:
        print(f"halo_exchange_w {tuple(r['shape'])} {r['dtype']} ({r['left']},{r['right']}) "
              f"x{r['count']}, ms per call: kernel {r['kernel_ms']:.4f} ({kernel}), exchange "
              f"{r['exchange_ms']:.4f} (back to back, host clock), plain ring "
              f"{r['plain_ms']:.4f}, ring messages {r['library_ms']:.4f}; bound "
              f"{r['bound_ms']:.6f} (one card), {r['nvlink_bound_ms']:.6f} (NVLink) on {name}")
    totals = halo_totals(res["rows"], ("kernel_ms", "exchange_ms", "plain_ms", "library_ms",
                                       "bound_ms", "nvlink_bound_ms", "bytes"))
    for path, t in totals.items():
        print(f"halo_exchange_w per forward per rank, {path}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items() if k != "calls"))
    return {"backend": res["backend"], "route": route, "max_abs_err": res["max_abs_err"],
            "totals": totals}


def check_halo_loopback(torch) -> dict:
    """The signalled route on this card, in this process: a ring of 2 and
    of N_RANKS peers (``parallel.checks.LoopbackRing``: each peer its own
    slab and stream, the peers' kernels co-resident), at every exchange
    shape of HALO_CALLS, periodic and zero-edge, LOOPBACK_ROUNDS exchanges
    back to back with fresh shards each, every halo bitwise the ring's.
    Then at N_RANKS peers, per shape: the device time of an exchange (its
    send and receive kernels per peer, torch.profiler, over LOOPBACK_TIMED
    back-to-back exchanges; each kernel's time includes its waits on the
    other peers) and the CUDA-event time per exchange of the whole ring
    (the peers' exchanges run at once; one host thread launches all of
    them); per sharded path the per-forward sums."""
    from biasgan_tpu_torch.parallel.checks import LoopbackRing, ring_halos

    dev = torch.device("cuda", 0)
    calls = halo_call_shapes()
    g = torch.Generator(device=dev).manual_seed(7)
    t0 = time.perf_counter()
    for peers in (2, N_RANKS):
        for periodic in (True, False):
            ring = LoopbackRing(peers, periodic, 1 << 20, dev)
            for shape, dt, left, right, _ in calls:
                rounds = [[torch.randn(shape, generator=g, device=dev).to(getattr(torch, dt))
                           for _ in range(peers)] for _ in range(LOOPBACK_ROUNDS)]
                got = ring.run(rounds, left, right)
                bad = [i for i, (xs, halos) in enumerate(zip(rounds, got))
                       if not all(torch.equal(a, wa) and torch.equal(b, wb) for (a, b), (wa, wb)
                                  in zip(halos, ring_halos(xs, left, right, periodic)))]
                check(not bad, f"loopback ring of {peers} (periodic={periodic}) {shape} {dt} "
                      f"({left},{right}): exchanges {bad} differ from the ring's halos")
                del rounds, got
            ring.close()
    print(f"halo_exchange_w signalled loopback: rings of 2 and {N_RANKS} peers on this card, "
          f"{len(calls)} shapes x periodic/zero-edge x {LOOPBACK_ROUNDS} back-to-back "
          f"exchanges, fresh shards each: every halo bitwise the ring's "
          f"({time.perf_counter() - t0:.1f} s)")
    ring = LoopbackRing(N_RANKS, True, 1 << 20, dev)
    rows = []
    for shape, dt, left, right, count in calls:
        xs = [torch.randn(shape, generator=g, device=dev).to(getattr(torch, dt))
              for _ in range(N_RANKS)]

        def run():
            ring.run([xs] * LOOPBACK_TIMED, left, right)

        event_ms = min(timed(torch, run, iters=1, warmup=1) for _ in range(2)) / LOOPBACK_TIMED
        by_kernel = device_time(torch, run, iters=1)
        device_ms = sum(v for k, v in by_kernel.items() if k.startswith("signal_")) / (
            LOOPBACK_TIMED * N_RANKS)
        moved = shape[0] * shape[1] * (left + right) * shape[3] * (4 if dt == "float32" else 2)
        rows.append({"shape": list(shape), "dtype": dt, "left": left, "right": right,
                     "count": count, "device_ms": device_ms, "event_ms": event_ms,
                     "bound_ms": 2 * moved / PEAK_BYTES * 1e3})
        print(f"halo_exchange_w signalled loopback {tuple(shape)} {dt} ({left},{right}) "
              f"x{count}: device ms per exchange per peer {device_ms:.5f} (send + receive "
              f"kernels, their waits included), CUDA events per exchange of the ring "
              f"{event_ms:.5f}; bound {rows[-1]['bound_ms']:.6f}")
    ring.close()
    totals = halo_totals(rows, ("device_ms", "event_ms", "bound_ms"))
    for path, t in totals.items():
        print(f"halo_exchange_w signalled loopback per forward per peer, {path}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items() if k != "calls"))
    return totals


def sharded_rank(rank, n, device, say, *args):
    """``parallel.checks.generator_cases`` on the card with TF32 off."""
    import torch

    from biasgan_tpu_torch.parallel.checks import generator_cases

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return generator_cases(rank, n, device, say, *args)


def check_small_sharded(torch) -> None:
    """resnet_3blocks (ngf 16, f32) sharded over N_RANKS ranks on this card,
    through the plain ring and the halo kernel, with and without the fused
    blocks (the conv kernel's halo W mode), against its whole-field forward
    on the card; each rank's launches counted."""
    from biasgan_tpu_torch.nn import define_G
    from biasgan_tpu_torch.parallel import spawn

    spec = dict(netG="resnet_3blocks", input_nc=3, output_nc=3, ngf=16, norm="instance",
                out_activation="none")
    g = torch.Generator().manual_seed(3)
    G = define_G(**spec, w_mode="wrap", generator=g)
    state = {k: v.numpy() for k, v in G.state_dict().items()}
    x = torch.randn((1, 16, 32 * N_RANKS, 3), generator=g)  # block-resolution shard: 8 wide
    cases = [dict(w_mode="wrap", fused=False, rdma=False),
             dict(w_mode="wrap", fused=False, rdma=True),
             dict(w_mode="zero", fused=True, rdma=True),
             dict(w_mode="wrap", fused=True, rdma=True)]
    torch.cuda.empty_cache()
    res = spawn(sharded_rank, N_RANKS, (spec, state, x.numpy(), cases), device="cuda",
                timeout=600, group_timeout=300)
    for case, got in zip(cases, res["outputs"]):
        Gw = define_G(**spec, w_mode=case["w_mode"])
        Gw.load_state_dict(G.state_dict())
        with torch.inference_mode():
            ref = Gw.to("cuda").eval()(x.cuda()).cpu()
        err = float((torch.from_numpy(got) - ref).abs().max())
        print(f"resnet_3blocks (1,16,{32 * N_RANKS},3) f32 sharded over {N_RANKS} ranks {case}: "
              f"vs whole field on the card max|dy| {err:.3g}")
        check(err <= 2e-4 * (1 + float(ref.abs().max())), f"small sharded forward {case}: "
              f"off by {err:.3g}")
    # 12 exchanges per forward (stem, 2 downs, 6 block convs, 2 ups, head)
    # in the three rdma cases; 6 fused block convs in the two fused ones
    want = {"halo_exchange_w": 36, "conv3x3_fused": 12}
    for r, counts in enumerate(res["launches"]):
        got = {k: counts[k] for k in want}
        check(got == want and sum(counts.values()) == sum(want.values()),
              f"small sharded forward: rank {r} launches {counts}, expected {want}")
    print(f"small sharded forward: every rank launched {want}")


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


def serve_argv(work: str, path: str) -> list:
    """The infer command line of served path ``path`` over the store."""
    return [
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


def serve(torch, work: str, path: str):
    """One infer.main run over the store on ``path``; returns (fields,
    per-field ms, per-field Mpx/s, kernel launches). Every kernel's count
    is set to 0 just before the run and read just after it; a sharded
    path's ranks count in their own processes, from 0, and infer.main
    prints their counts (rank 0's are returned)."""
    import numpy as np

    from biasgan_tpu_torch import infer
    from biasgan_tpu_torch.kernels import launch_counts

    argv = serve_argv(work, path)
    out = io.StringIO()
    sharded = "--spatial_mesh" in PATHS[path][0]
    if sharded:
        torch.cuda.empty_cache()
    zero_counts()
    with contextlib.redirect_stdout(out):
        out_dir = infer.main(argv)
    log = out.getvalue()
    per_rank = [launch_counts()]
    if sharded:
        m = re.search(r"spatial: kernel launches per rank (\[.*\])", log)
        check(m is not None, f"{path}: no launch counts from the ranks")
        per_rank = json.loads(m.group(1))
        check(len(per_rank) == N_RANKS, f"{path}: launch counts of {len(per_rank)} ranks")
    lines = [ln for ln in log.splitlines() if ln.startswith(("[", "--", "spatial:"))]
    print("\n".join(f"  {path}: {ln}" for ln in lines))
    stamps = re.findall(r"corrected in ([0-9.]+) ms \(([0-9.]+) Mpx/s\)", log)
    check(len(stamps) == N_TIMES, f"{path}: expected {N_TIMES} served fields, got {len(stamps)}")
    fields = []
    for i in range(N_TIMES):
        y = np.load(os.path.join(out_dir, f"corrected_{i:05d}.npy"))
        check(y.shape == (1, GLOBE_H, GLOBE_W, N_VARS), f"{path}: field {i} shape {y.shape}")
        check(bool(np.isfinite(y).all()), f"{path}: field {i} has non-finite values")
        fields.append(y)
    per_field = with_path_counts(PATHS[path][1], "bfloat16", NORM_CALLS.get(path, ()))
    want = {name: per_field.get(name, 0) * N_TIMES for name in per_rank[0]}
    for r, launches in enumerate(per_rank):
        check(launches == want, f"{path}: rank {r} kernel launches {launches}, expected "
              f"{want} ({N_TIMES} fields)")
    if "--halo_rdma" in PATHS[path][0]:
        check_halo_route(torch, path, log, want["halo_exchange_w"])
    taken = {k: v for k, v in per_rank[0].items()
             if k.endswith((".wgmma_launches", ".cluster_launches", ".persistent_launches")) and v}
    if taken:
        print(f"  {path}: launches on each kernel's path (bf16 TMA / wgmma, norm cluster or "
              "persistent)"
              + (" on every rank" if sharded else "") + f" {taken}")
    return fields, [float(s[0]) for s in stamps], [float(s[1]) for s in stamps], per_rank[0]


def check_halo_route(torch, path: str, log: str, exchanges: int) -> None:
    """The route of every exchange of a sharded --halo_rdma serve, from its
    last line (each rank's counts): with a card per rank every exchange
    signalled on the device and no host sync; with ranks sharing a card,
    the host route's stream sync and barrier in each."""
    m = re.search(r"spatial: halo exchanges per rank (\[.*\])", log)
    check(m is not None, f"{path}: no halo exchange counts from the ranks")
    want = "signalled" if torch.cuda.device_count() >= N_RANKS else "host"
    for r, c in enumerate(json.loads(m.group(1))):
        syncs = 0 if want == "signalled" else 2 * exchanges
        check(c == {"route": want, "exchanges": exchanges,
                    "signalled": exchanges if want == "signalled" else 0, "host_syncs": syncs},
              f"{path}: rank {r} halo exchanges {c}, expected {exchanges} on the {want} route "
              f"with {syncs} host syncs")
    print(f"  {path}: every rank's {exchanges} exchanges took the {want} route"
          + (", none synchronised on the host" if want == "signalled" else ""))


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
    ref = served["plain"][0][0]
    for path in PATHS:
        if path == "plain":
            continue
        diff = np.abs(served[path][0][0] - ref)
        excess = diff - (0.02 * np.abs(ref) + 0.1 * std)
        print(
            f"field 0, {path} vs plain path: max |dy| {float((diff / std).max()):.4g} std "
            f"at column {int(np.unravel_index(diff.argmax(), diff.shape)[2])}, mean |dy| "
            f"{float((diff / std).mean()):.4g} std, worst margin to the bf16 bound "
            f"{float(excess.max()):.4g}"
        )
        check(float(excess.max()) <= 0 and float((diff / std).mean()) <= 0.01,
              f"{path} and plain globe outputs disagree beyond bf16 tolerance")
    # the halo kernel moves the same bytes as the ring: the same fields
    rdma_err = max(float(np.abs(a - b).max())
                   for a, b in zip(served["spatial_rdma"][0], served["spatial"][0]))
    print(f"spatial_rdma vs spatial (the plain ring), every field: max |dy| {rdma_err:.4g}")
    check(rdma_err <= 2e-5, f"--halo_rdma fields differ from the ring's by {rdma_err:.3g}")
    name = torch.cuda.get_device_name(0)
    for path, (_, ms, mpx, _) in served.items():
        shared = ""
        if "--spatial_mesh" in PATHS[path][0] and torch.cuda.device_count() < N_RANKS:
            shared = (f"; {N_RANKS} ranks time-slice this one card: a smoke reading of the "
                      "path, not a multi-card speed")
        print(
            f"globe {GLOBE_H}x{GLOBE_W}x{N_VARS} bf16 {path}: ms/field {ms} "
            f"(field 0 warms up; median of the rest {statistics.median(ms[1:]):.1f}), "
            f"Mpx/s {mpx} on {name}{shared}"
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
# training route -> (train flags, launches per step: each kernel's (the
# fused conv's and the instance norm's backward kernels among them), the
# differentiable fused conv's, and the VALID conv's input-gradient ones).
# Per step: 3 G dispatches x 18 block convs; 3 x (stem + head); the
# all-kernel route's norms: 3 x 5 in the Gs, 4 D forwards x 3 in the Ds.
TRAIN_ROUTES = {
    "plain": ([], {}),
    "fused": (["--fused_blocks"], {"conv3x3_fused": 54, "conv3x3_fused_t": 54,
                                   "conv3x3_fused_bwd": 54}),
    "pallas_conv": (["--pallas_conv", "1"], {"conv3x3_valid": 54, "conv3x3_valid.bwd": 54}),
    "all": (["--fused_blocks", "--conv7_pallas", "1", "--force_pallas_norm"],
            {"conv3x3_fused": 54, "conv3x3_fused_t": 54, "conv3x3_fused_bwd": 54,
             "conv7x7": 6, "instance_norm_act": 27, "instance_norm_act_bwd": 27}),
}


def _counters():
    """Every launch count: name -> (function object, attribute): the kernel
    wrappers' (their bf16 paths' too), and the training-only ones."""
    from biasgan_tpu_torch.kernels import counters
    from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused_t

    c = counters()
    c["conv3x3_fused_t"] = (conv3x3_fused_t, "launches")
    c["conv3x3_valid.bwd"] = (kernel_fns("conv3x3_valid")[0], "bwd_launches")
    return c


def zero_counts() -> None:
    for obj, attr in _counters().values():
        setattr(obj, attr, 0)


def read_counts() -> dict:
    return {k: getattr(obj, attr) for k, (obj, attr) in _counters().items()}


def train_argv(route, dtype, work, name, save=False, extra=()):
    return TRAIN_ARGS + TRAIN_ROUTES[route][0] + [
        "--compute_dtype", dtype, "--checkpoints_dir", os.path.join(work, "train"),
        "--name", name, "--save_epoch_freq", "1" if save else "100",
    ] + list(extra)


def _by_net_max(grads):
    """net -> the largest |grad| over its parameters."""
    out = {}
    for k, v in grads.items():
        net = k.split(".", 1)[0]
        out[net] = max(out.get(net, 0.0), float(v.float().abs().max()))
    return out


def train_steps(torch, route, dtype, work, perturb=0.0, timed_steps=True, extra=()) -> dict:
    """Step 1 from the seeded state on the first batch (its A and B moved
    by ``perturb`` relative noise, for the noise floor), with the step's
    gradients and exact launch counts; then 5 more steps, timed (host
    clock, synchronized), with finite losses. ``extra``: more flags."""
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.data import create_dataset
    from biasgan_tpu_torch.models.common import step_generator
    from biasgan_tpu_torch.models.cyclegan import create_state, make_train_step
    from biasgan_tpu_torch.train import batch_to

    cfg = parse_config(train_argv(route, dtype, work, f"steps_{route}_{dtype}", extra=extra),
                       train=True)
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
    per_step = with_path_counts(TRAIN_ROUTES[route][1], dtype, NORM_CALLS.get(route, ()))
    want = {k: per_step.get(k, 0) for k in counts}
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
    per_step = with_path_counts(TRAIN_ROUTES[route][1], dtype, NORM_CALLS.get(route, ()))
    want = {k: per_step.get(k, 0) * TRAIN_SAMPLES for k in counts}
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


# ---------------------------------------------------------------------------
# Sharded training: the same CycleGAN over N_RANKS W shards
# ---------------------------------------------------------------------------

# sharded training route -> (train flags, launches per rank per step)
SHARDED_ROUTES = {
    "spatial_fused": (["--fused_blocks"], {"conv3x3_fused": 54, "conv3x3_fused_t": 54,
                                           "conv3x3_fused_bwd": 54}),
    "spatial": ([], {}),
}
SHARDED_FLAGS = ["--spatial_mesh", str(N_RANKS), "--w_pad_mode", "wrap"]
SHARDED_CLI_STEPS = 3  # the CLI's steps per route (bf16); ms/step over the last 2


def sharded_train_rank(rank, n, device, say, *args):
    """``parallel.checks.train_cases`` on the card with TF32 off."""
    import torch

    from biasgan_tpu_torch.parallel.checks import train_cases

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return train_cases(rank, n, device, say, *args)


def sharded_train_phase(torch, work) -> dict:
    """The CycleGAN of the training phase with --w_pad_mode wrap (sharding
    cannot reflect W), sharded over N_RANKS ranks on the card(s), on each
    route of SHARDED_ROUTES. Step 1, from the seeded state, the first batch
    and the step's generator, is held to the one-card plain step 1 of the
    same configuration by the training phase's rules (losses; per-net
    gradients within the noise floor rule), f32 and bf16, with exact launch
    counts per rank and parameters bitwise equal on every rank. Then
    ``train.main`` runs SHARDED_CLI_STEPS steps per route in bf16: finite
    losses, exact launches per rank, parameters bitwise equal, and rank 0's
    ms/step."""
    from biasgan_tpu_torch import train
    from biasgan_tpu_torch.parallel import placement, spawn

    name = card()
    out = {"launches": {}, "ms_per_step": {}, "step_ms": {}, "grad_rel_l2": {}, "card": name}
    cases, refs = [], {}
    for dtype in ("float32", "bfloat16"):
        ref = train_steps(torch, "plain", dtype, work, timed_steps=False,
                          extra=["--w_pad_mode", "wrap"])
        moved = train_steps(torch, "plain", dtype, work, perturb=NOISE_INPUT[dtype],
                            timed_steps=False, extra=["--w_pad_mode", "wrap"])
        floor = grad_distance(moved, ref)[1]
        refs[dtype] = ({"losses": ref["losses"],
                        **{w: {k: v.cpu() for k, v in ref[w].items()} for w in ("G", "D")}},
                       floor)
        del ref, moved
        for route, (flags, _) in SHARDED_ROUTES.items():
            cases.append(dict(flags=["--compute_dtype", dtype] + flags, steps=1,
                              grads=os.path.join(work, f"grads_{route}_{dtype}.pt"),
                              route=route, dtype=dtype))
    torch.cuda.empty_cache()
    argv = TRAIN_ARGS + SHARDED_FLAGS + ["--checkpoints_dir", os.path.join(work, "sharded")]
    t0 = time.perf_counter()
    res = spawn(sharded_train_rank, N_RANKS, (argv, cases), device="cuda", timeout=900,
                group_timeout=600)
    print(f"sharded training: {placement(N_RANKS, 'cuda')}: step 1 of {len(cases)} cases "
          f"({time.perf_counter() - t0:.1f} s)")
    fails = []
    for case, got in zip(cases, res):
        route, dtype = case["route"], case["dtype"]
        want = {k: v for k, v in with_path_counts(SHARDED_ROUTES[route][1], dtype).items() if v}
        for r, counts in enumerate(got["launches"]):
            counts = {k: v for k, v in counts.items() if v}
            if counts != want:
                fails.append(f"sharded {route} {dtype} step 1: rank {r} launches {counts}, "
                             f"expected {want}")
        if not got["params_equal"]:
            fails.append(f"sharded {route} {dtype}: the ranks' parameters differ after step 1")
        grads = torch.load(case["grads"], weights_only=True)
        ref, floor = refs[dtype]
        held = hold_first_step(route, dtype, {"losses": got["losses"][0], **grads}, ref, floor)
        fails += held["fails"]
        out["grad_rel_l2"][f"{route}/{dtype}"] = held["grad_rel_l2"]
        print(f"sharded {route} {dtype}: step 1 held to the one-card plain step (wrap): "
              f"losses {got['losses'][0]}; largest grad |d| {held['worst_grad_err']:.3g} of "
              f"max(1, net max); relative L2 per net {held['grad_rel_l2']} (noise floor "
              f"{floor}); launches per rank {got['launches'][0]}")
    check(not fails, "; ".join(fails))
    for route, (flags, per_step) in SHARDED_ROUTES.items():
        log = io.StringIO()
        zero_counts()
        torch.cuda.empty_cache()
        with contextlib.redirect_stdout(log):
            result = train.main(train_argv("plain", "bfloat16", work, f"sharded_{route}",
                                           extra=SHARDED_FLAGS + flags + [
                                               "--synthetic_samples", str(SHARDED_CLI_STEPS)]))
        lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("(epoch:")]
        check(len(lines) == SHARDED_CLI_STEPS, f"sharded CLI {route}: {len(lines)} loss lines")
        # --print_freq 1: each line's time is its step's, synchronised
        ms = [float(re.search(r"time: ([0-9.]+)", ln).group(1)) * 1e3 for ln in lines]
        check(not any("nan" in ln or "inf" in ln for ln in lines),
              f"sharded CLI {route}: non-finite loss")
        check(result["params_equal"], f"sharded CLI {route}: the ranks' parameters differ")
        want = {k: v * SHARDED_CLI_STEPS
                for k, v in with_path_counts(per_step, "bfloat16").items() if v}
        for r, counts in enumerate(result["launches"]):
            counts = {k: v for k, v in counts.items() if v}
            check(counts == want, f"sharded CLI {route}: rank {r} launches {counts}, "
                  f"expected {want}")
        out["launches"][route] = result["launches"][0]
        out["step_ms"][route] = ms
        out["ms_per_step"][route] = statistics.mean(ms[1:])
        for ln in log.getvalue().splitlines():
            if re.match(r"--\w|spatial:|\(epoch: 1, iters: 3,", ln):
                print(f"  sharded cli {route}: {ln}")
        shared = ("" if torch.cuda.device_count() >= N_RANKS else
                  f"; {N_RANKS} ranks time-slice this one card: a smoke reading, not a "
                  "multi-card speed")
        print(f"sharded training {route}, 256x256 batch 1 bf16, --spatial_mesh {N_RANKS}: "
              f"rank 0 ms/step {ms} (step 1 warms up; mean of the rest "
              f"{out['ms_per_step'][route]:.1f}) on {name}{shared}")
    return out


# ---------------------------------------------------------------------------
# pix2pix: the reference's default model on one card
# ---------------------------------------------------------------------------

# the JAX bench's configuration (bench.py:180-195): unet_256 G, basic D,
# batch norm, vanilla GAN + L1, no pool, dropout on, 256x256, 3 channels,
# ngf / ndf 64; here at the reference's batch 1 on seeded synthetic data
P2P_ARGS = [
    "--model", "pix2pix", "--dataset_mode", "synthetic", "--seed", "0",
    "--netG", "unet_256", "--netD", "basic", "--norm", "batch", "--gan_mode", "vanilla",
    "--pool_size", "0", "--ngf", "64", "--ndf", "64", "--crop_size", "256",
    "--input_nc", "3", "--output_nc", "3", "--batch_size", "1",
    "--synthetic_samples", str(TRAIN_SAMPLES), "--n_epochs", "1", "--n_epochs_decay", "0",
    "--print_freq", "1", "--save_latest_freq", "1000000",
]
# the kernel route through the pix2pix step: K2 on the resnet's 18 block
# convs, forward and backward, once a step (one G forward), held to the
# same step without it
P2P_PLAIN = ["--netG", "resnet_9blocks", "--norm", "instance", "--no_dropout",
             "--gan_mode", "lsgan"]
P2P_ROUTE = P2P_PLAIN + ["--fused_blocks"]
P2P_ROUTE_STEP = {"conv3x3_fused": 18, "conv3x3_fused_t": 18, "conv3x3_fused_bwd": 18}
P2P_ROUTE_STEPS = 2
BENCH_BATCH, BENCH_STEPS = 128, 3  # bench.py's batch, three timed steps


def p2p_argv(work, name, *extra):
    return P2P_ARGS + ["--checkpoints_dir", os.path.join(work, "pix2pix"), "--name", name,
                       *extra]


def p2p_first_step(torch, device, argv, perturb=0.0) -> dict:
    """Step 1 of the pix2pix step on ``device`` from the seeded nets (drawn
    on the CPU, so the same on every device) and the first synthetic batch
    (moved by ``perturb`` relative noise for the noise floor): the losses,
    and the step's gradients as Adam's first moment after it gives them
    (mu = (1 - b1) g, the moments start at 0), per net."""
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.data import create_dataset
    from biasgan_tpu_torch.models.common import step_generator
    from biasgan_tpu_torch.models.pix2pix import create_state, make_train_step
    from biasgan_tpu_torch.train import batch_to

    cfg = parse_config(argv + ["--device", str(device)], train=True)
    cfg.steps_per_epoch = TRAIN_SAMPLES
    batch = batch_to(next(iter(create_dataset(cfg))), device)
    if perturb:
        g = torch.Generator().manual_seed(11)
        for k in ("A", "B"):
            x = batch[k]
            batch[k] = x * (1 + perturb * torch.randn(x.shape, generator=g).to(device))
    state = create_state(cfg, device)
    losses, _ = make_train_step(cfg)(state, batch, step_generator(cfg.seed, 0))
    grads = {net: {k: (v / (1 - opt.b1)).cpu() for k, v in opt.mu.items()}
             for net, opt in state.opts.items()}
    return {"losses": {k: float(v) for k, v in losses.items()}, **grads}


def p2p_cli(torch, argv, steps) -> tuple:
    """``train.main`` on ``argv``; every launch count set to 0 just before
    and read just after. Returns (launches, state, the loss lines)."""
    from biasgan_tpu_torch import train

    out = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(out):
        state = train.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("(epoch:")]
    check(len(lines) == steps, f"pix2pix CLI: {len(lines)} loss lines, expected {steps}")
    check(not any("nan" in ln or "inf" in ln for ln in lines), "pix2pix CLI: non-finite loss")
    for ln in out.getvalue().splitlines():
        if ln.startswith("--") or ln.startswith("(epoch:"):
            print(f"  cli: {ln}")
    return counts, state, lines


def pix2pix_phase(torch, work) -> dict:
    """pix2pix on the card (module docstring, phase 9): the bench
    configuration through the training CLI; its first step on the card held
    to the CPU's for vanilla, lsgan and wgangp; bench.py's batch of 128;
    K2 through the pix2pix step; the trained U-Net serving a globe field."""
    import numpy as np

    from biasgan_tpu_torch import infer
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.models.pix2pix import create_state, make_train_step

    name = card()
    out = {"card": name}
    fails = []
    dev, cpu = torch.device("cuda"), torch.device("cpu")

    # (1) the bench configuration through the CLI, bf16, six steps, a save
    argv = p2p_argv(work, "cli", "--compute_dtype", "bfloat16", "--save_epoch_freq", "1",
                    "--device", "cuda")
    t0 = time.perf_counter()
    counts, state, lines = p2p_cli(torch, argv, TRAIN_SAMPLES)
    out["cli_s"] = time.perf_counter() - t0
    check(not any(counts.values()), f"pix2pix unet_256: kernel launches {counts}, expected "
          "none (the U-Net and the PatchGAN reach no kernel, as in JAX)")
    run_dir = os.path.join(work, "pix2pix", "cli")
    moved = {}
    for net in ("G", "D"):
        sd = torch.load(os.path.join(run_dir, f"latest_net_{net}.pth"), weights_only=True)
        means = [v for k, v in sd.items() if k.endswith("running_mean")]
        moved[net] = sum(int((v != 0).any()) for v in means)
        check(means and moved[net] == len(means),
              f"pix2pix: saved {net} has {moved[net]} of {len(means)} running means moved")
    out["running_means_moved"] = moved
    out["cli_loss_lines"] = lines
    del state

    # (2) step 1 at full width, dropout off, f32 (TF32 off): the card's
    # against the CPU's (which the CPU tests hold to JAX), per GAN mode. The
    # noise floor is the larger of the two sides' own moves under the input
    # perturbation: the first chip run read the card's wgangp G floor at
    # 9.6e-6 and the CPU's at 6.8e-4 (the step's D update is Adam's
    # sign-like first step, so which near-zero D gradients flip decides
    # how far G's gradients move), and CPU against card at 1.6e-3
    out["first_step"] = {}
    for mode in ("vanilla", "lsgan", "wgangp"):
        argv = p2p_argv(work, f"step_{mode}", "--no_dropout", "--gan_mode", mode)
        ref = p2p_first_step(torch, dev, argv)
        floor_card = grad_distance(
            p2p_first_step(torch, dev, argv, perturb=NOISE_INPUT["float32"]), ref)[1]
        t0 = time.perf_counter()
        got = p2p_first_step(torch, cpu, argv)
        cpu_s = time.perf_counter() - t0
        floor_cpu = grad_distance(
            p2p_first_step(torch, cpu, argv, perturb=NOISE_INPUT["float32"]), got)[1]
        floor = {net: max(floor_card[net], floor_cpu[net]) for net in floor_card}
        held = hold_first_step(f"pix2pix {mode} CPU", "float32", got, ref, floor)
        fails += held["fails"]
        out["first_step"][mode] = {"losses_card": ref["losses"], "losses_cpu": got["losses"],
                                   "grad_rel_l2": held["grad_rel_l2"],
                                   "noise_floor_card": floor_card, "noise_floor_cpu": floor_cpu,
                                   "worst_grad_err": held["worst_grad_err"]}
        print(f"pix2pix {mode} f32 step 1, CPU vs {name}: losses card {ref['losses']} cpu "
              f"{got['losses']}; relative L2 per net {held['grad_rel_l2']} (noise floor: card "
              f"{floor_card}, CPU {floor_cpu}); CPU step {cpu_s:.1f} s")
        torch.cuda.empty_cache()

    # (3) bench.py's batch: 128 at 256x256, bf16, dropout on
    cfg = parse_config(p2p_argv(work, "bench", "--batch_size", str(BENCH_BATCH),
                                "--compute_dtype", "bfloat16", "--no-in_graph_aug",
                                "--device", "cuda"), train=True)
    cfg.steps_per_epoch = 1000
    a = torch.randn((BENCH_BATCH, 256, 256, 3), generator=torch.Generator().manual_seed(1))
    batch = {"A": a.to(dev), "B": torch.tanh(a).to(dev)}
    torch.cuda.reset_peak_memory_stats()
    state = create_state(cfg, dev)
    step = make_train_step(cfg)
    ms = []
    for i in range(BENCH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(float(v)) for v in losses.values()),
              f"pix2pix batch {BENCH_BATCH}: non-finite loss")
    peak = torch.cuda.max_memory_allocated()
    out["bench"] = {"batch": BENCH_BATCH, "step_ms": ms,
                    "samples_per_s": BENCH_BATCH * 1e3 / statistics.mean(ms[1:]),
                    "max_memory_allocated": peak}
    print(f"pix2pix bench configuration, batch {BENCH_BATCH}, 256x256 bf16, dropout on: "
          f"ms/step {ms} (step 1 warms up), {out['bench']['samples_per_s']:.1f} samples/s "
          f"over steps 2-{BENCH_STEPS}, max_memory_allocated {peak / 2**30:.2f} GiB on "
          f"{name} (smoke)")
    del state, step, batch
    torch.cuda.empty_cache()

    # (4) K2 through the pix2pix step: step 1 held to the plain route's,
    # then the CLI's two steps with exact launches
    plain = p2p_argv(work, "route", *P2P_PLAIN, "--compute_dtype", "bfloat16")
    ref = p2p_first_step(torch, dev, plain)
    floor = grad_distance(p2p_first_step(torch, dev, plain, perturb=NOISE_INPUT["bfloat16"]),
                          ref)[1]
    zero_counts()
    got = p2p_first_step(torch, dev, plain + ["--fused_blocks"])
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: v for k, v in with_path_counts(P2P_ROUTE_STEP, "bfloat16").items() if v}
    check({k: v for k, v in counts.items() if v} == want,
          f"pix2pix --fused_blocks step 1: launches {counts}, expected {want}")
    held = hold_first_step("pix2pix fused", "bfloat16", got, ref, floor)
    fails += held["fails"]
    print(f"pix2pix resnet_9blocks --fused_blocks bf16 step 1 held to plain: losses "
          f"{got['losses']} vs {ref['losses']}; relative L2 per net {held['grad_rel_l2']} "
          f"(noise floor {floor})")
    argv = p2p_argv(work, "route_cli", *P2P_ROUTE, "--compute_dtype", "bfloat16",
                    "--synthetic_samples", str(P2P_ROUTE_STEPS), "--device", "cuda")
    counts, state, _ = p2p_cli(torch, argv, P2P_ROUTE_STEPS)
    want = {k: v * P2P_ROUTE_STEPS
            for k, v in with_path_counts(P2P_ROUTE_STEP, "bfloat16").items() if v}
    check({k: v for k, v in counts.items() if v} == want,
          f"pix2pix --fused_blocks CLI: launches {counts}, expected {want}")
    out["route"] = {"flags": P2P_ROUTE, "launches": counts,
                    "grad_rel_l2": held["grad_rel_l2"], "noise_floor": floor}
    del state
    torch.cuda.empty_cache()

    # (5) the trained U-Net serves one field of the globe store
    res = io.StringIO()
    with contextlib.redirect_stdout(res):
        out_dir = infer.main([
            "--model", "pix2pix", "--dataset_mode", "climate",
            "--dataroot", os.path.join(work, "data"), "--full_field",
            "--checkpoints_dir", os.path.join(work, "pix2pix"), "--name", "cli",
            "--results_dir", os.path.join(work, "results_pix2pix"),
            "--netG", "unet_256", "--norm", "batch", "--ngf", "64",
            "--input_nc", str(N_VARS), "--output_nc", str(N_VARS),
            "--compute_dtype", "bfloat16", "--num_test", "1", "--device", "cuda"])
    stamps = re.findall(r"corrected in ([0-9.]+) ms", res.getvalue())
    y = np.load(os.path.join(out_dir, "corrected_00000.npy"))
    check(len(stamps) == 1 and y.shape == (1, GLOBE_H, GLOBE_W, N_VARS)
          and bool(np.isfinite(y).all()), f"pix2pix serve: {stamps}, field {y.shape}")
    out["serve_ms_per_field"] = float(stamps[0])
    ph, pw = (-(-n // 256) * 256 for n in (GLOBE_H, GLOBE_W))
    print(f"pix2pix unet_256 serves a {GLOBE_H}x{GLOBE_W}x{N_VARS} field (padded to {ph}x{pw}) "
          f"in {stamps[0]} ms (one field, the first: a cold call) on {name}")
    check(not fails, "; ".join(fails))
    return out


# ---------------------------------------------------------------------------
# data parallelism: --data_mesh 2, and the validation metrics
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_STEPS = 5  # the bench configuration's CLI steps; ms/step over steps 2-5
DP_HELD_BATCH = 2  # the held step's global batch: one sample a rank
# CycleGAN at its defaults through --data_mesh 2 on the kernel routes of
# phase 7, two bf16 steps of global batch 2 (one sample a rank, as batch 1
# on one card); the kernels each route runs, by name
DP_CG_STEPS = 2
DP_CG_FLAGS = ["--data_mesh", str(DP_RANKS), "--batch_size", str(DP_RANKS),
               "--synthetic_samples", str(DP_RANKS * DP_CG_STEPS)]
DP_CG_ROUTES = {"fused": ("conv3x3_fused", "conv3x3_fused_bwd"),
                "pallas_conv": ("conv3x3_valid",),
                "all": ("conv7x7", "instance_norm_act", "instance_norm_act_bwd")}
METRIC_RTOL = 1e-4  # rmse, bias and the log-spectral distance, card against CPU


def dp_rank(rank, n, device, say, cases):
    """``parallel.checks.data_cases`` with TF32 off on the card."""
    import torch

    from biasgan_tpu_torch.parallel.checks import data_cases

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return data_cases(rank, n, device, say, cases)


def dp_first_batch(argv, perturb=0.0) -> dict:
    """The first global batch of ``argv``'s synthetic dataset as numpy
    (its A and B moved by ``perturb`` relative noise, for the noise
    floor)."""
    import numpy as np

    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.data import create_dataset

    batch = next(iter(create_dataset(parse_config(argv + ["--device", "cpu"], train=True))))
    batch = {k: v for k, v in batch.items() if not k.endswith("_paths")}
    if perturb:
        rng = np.random.default_rng(11)
        batch = {k: (v * (1 + perturb * rng.normal(size=v.shape))).astype(np.float32)
                 for k, v in batch.items()}
    return batch


def dp_held_steps(torch, work) -> tuple:
    """Step 1 of the data-parallel pix2pix step at the bench configuration's
    widths, f32, dropout off, global batch DP_HELD_BATCH, held by the rules
    of phase 7 (noise floors as phase 9 takes them): instance norm, the
    ranks on the card against the one-device step on the card on the
    global batch; batch norm, the ranks on the card against the ranks on
    the CPU (which tier-1 holds to JAX's data-parallel step). Returns
    (results, failures)."""
    from biasgan_tpu_torch.parallel import spawn

    base = P2P_ARGS + ["--no_dropout", "--no-in_graph_aug", "--batch_size",
                       str(DP_HELD_BATCH), "--checkpoints_dir", os.path.join(work, "dp_held")]
    argv = {norm: base + ["--norm", norm, "--name", norm] for norm in ("instance", "batch")}

    def case(norm, device, perturb=0.0):
        tag = f"{norm}_{device}_{'moved' if perturb else 'ref'}"
        return {"argv": argv[norm] + ["--device", device],
                "batches": [dp_first_batch(argv[norm], perturb)],
                "grads": os.path.join(work, f"dp_grads_{tag}.pt"), "tag": tag}

    on_card = [case("instance", "cuda"), case("batch", "cuda"),
               case("batch", "cuda", NOISE_INPUT["float32"])]
    on_cpu = [case("batch", "cpu"), case("batch", "cpu", NOISE_INPUT["float32"])]
    got = {}
    for device, cases in (("cuda", on_card), ("cpu", on_cpu)):
        t0 = time.perf_counter()
        res = spawn(dp_rank, DP_RANKS, (cases,), device=device, timeout=600,
                    group_timeout=600)
        print(f"data-parallel held steps: {len(cases)} cases on {DP_RANKS} {device} ranks "
              f"({time.perf_counter() - t0:.1f} s)")
        for c, r in zip(cases, res):
            check(r["params_equal"], f"data-parallel {c['tag']}: the ranks' state differs")
            check(not any(v for counts in r["launches"] for v in counts.values()),
                  f"data-parallel {c['tag']}: kernel launches {r['launches']}")
            grads = torch.load(c["grads"], weights_only=True)
            got[c["tag"]] = {"losses": r["losses"][0], **grads}
    dev = torch.device("cuda")
    one = p2p_first_step(torch, dev, argv["instance"])
    moved = p2p_first_step(torch, dev, argv["instance"], perturb=NOISE_INPUT["float32"])
    floor_one = grad_distance(moved, one)[1]
    out, fails = {}, []
    held = hold_first_step("data-parallel instance norm, card ranks vs one card", "float32",
                           got["instance_cuda_ref"], one, floor_one)
    fails += held["fails"]
    out["instance"] = {"losses_ranks": got["instance_cuda_ref"]["losses"],
                       "losses_one": one["losses"], "grad_rel_l2": held["grad_rel_l2"],
                       "noise_floor": floor_one}
    floor_card = grad_distance(got["batch_cuda_moved"], got["batch_cuda_ref"])[1]
    floor_cpu = grad_distance(got["batch_cpu_moved"], got["batch_cpu_ref"])[1]
    floor = {net: max(floor_card[net], floor_cpu[net]) for net in floor_card}
    held_bn = hold_first_step("data-parallel batch norm, card ranks vs CPU ranks", "float32",
                              got["batch_cuda_ref"], got["batch_cpu_ref"], floor)
    fails += held_bn["fails"]
    out["batch"] = {"losses_card": got["batch_cuda_ref"]["losses"],
                    "losses_cpu": got["batch_cpu_ref"]["losses"],
                    "grad_rel_l2": held_bn["grad_rel_l2"], "noise_floor_card": floor_card,
                    "noise_floor_cpu": floor_cpu}
    for norm, h in (("instance", held), ("batch", held_bn)):
        print(f"data-parallel pix2pix {norm} norm f32 step 1 held: relative L2 per net "
              f"{h['grad_rel_l2']} (noise floor {out[norm].get('noise_floor', floor)})")
    return out, fails


def dp_metrics(torch) -> dict:
    """The metric bundle on the card against the same functions on the CPU
    for the same fields: rmse, bias and the log-spectral distance within
    METRIC_RTOL relative, pdf_tv within one count; and its time on the card
    at the bench batch."""
    import numpy as np

    from biasgan_tpu_torch.data.synthetic import smooth_field
    from biasgan_tpu_torch.ops.metrics import validation_metrics

    rng = np.random.default_rng(5)
    cases = {
        "bench batch (128,256,256,3) bf16, [-1, 1]": (
            np.tanh(rng.normal(size=(128, 256, 256, 3))), -1.0, 1.0, torch.bfloat16),
        "globe (1,721,1440,3) f32, [-5, 5]": (
            np.stack([smooth_field(rng, GLOBE_H, GLOBE_W, 2.0) for _ in range(N_VARS)],
                     -1)[None] * 3.0, -5.0, 5.0, torch.float32),
    }
    out = {}
    for name, (a, lo, hi, dtype) in cases.items():
        a = a.astype(np.float32)
        b = (a * 1.1 + 0.05 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        fields = [torch.from_numpy(x).to(dtype) for x in (a, b)]
        want = {k: float(v) for k, v in validation_metrics(*fields, lo, hi).items()}
        on_card = [f.cuda() for f in fields]
        got = {k: float(v) for k, v in validation_metrics(*on_card, lo, hi).items()}
        m = a.size // a.shape[-1]
        for k in ("rmse", "bias", "log_spectral_distance"):
            check(abs(got[k] - want[k]) <= METRIC_RTOL * abs(want[k]),
                  f"metrics {name}: {k} card {got[k]} vs CPU {want[k]}")
        check(abs(got["pdf_tv"] - want["pdf_tv"]) <= 1.0 / m + 1e-7,
              f"metrics {name}: pdf_tv card {got['pdf_tv']} vs CPU {want['pdf_tv']}")
        ms = timed(torch, lambda: validation_metrics(*on_card, lo, hi), iters=5, warmup=1)
        out[name] = {"card": got, "cpu": want, "ms": ms}
        print(f"metric bundle {name}: card {got}, CPU {want}; {ms:.3f} ms on the card")
    return out


def data_parallel_phase(torch, work) -> dict:
    """Data parallelism on the card (module docstring, phase 10): the bench
    configuration through ``train.main --data_mesh 2`` with the validation
    flags; step 1 held in f32; CycleGAN --fused_blocks --data_mesh 2 with
    K2's launches per rank; the metric bundle against the CPU."""
    from biasgan_tpu_torch import train
    from biasgan_tpu_torch.parallel import placement

    t_phase = time.perf_counter()
    name = card()
    print(placement(DP_RANKS, "cuda", kind="data"))
    out = {"card": name, "ranks": DP_RANKS}

    # (a) the bench configuration, bf16, global batch 128, dropout on, with
    # a held-out batch and one validation point (the last step)
    argv = p2p_argv(work, "dp_bench", "--batch_size", str(BENCH_BATCH), "--data_mesh",
                    str(DP_RANKS), "--compute_dtype", "bfloat16", "--no-in_graph_aug",
                    "--synthetic_samples", str(BENCH_BATCH * (DP_STEPS + 1)),
                    "--val_split", str(BENCH_BATCH), "--val_freq", str(BENCH_BATCH * DP_STEPS),
                    "--device", "cuda")
    log = io.StringIO()
    zero_counts()
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(log):
        result = train.main(argv)
    text = log.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("(epoch:")]
    check(len(lines) == DP_STEPS and not any("nan" in ln or "inf" in ln for ln in lines),
          f"data-parallel bench CLI: loss lines {lines}")
    for want in ("The number of validation images", "validation (train batch):",
                 "validation (held out):", "data: parameters bitwise equal on every rank: True"):
        check(want in text, f"data-parallel bench CLI: no line {want!r}")
    check(result["params_equal"], "data-parallel bench CLI: the ranks' state differs")
    check(not any(v for counts in result["launches"] for v in counts.values()),
          f"data-parallel bench CLI: kernel launches {result['launches']}, expected none")
    ms = result["step_ms"]
    reduces = [r["grad_reduces"] for r in result["ranks"]]
    check(reduces == [2 * DP_STEPS] * DP_RANKS,
          f"data-parallel bench CLI: grads' all-reduces per rank {reduces}, expected "
          f"{2 * DP_STEPS} (G and D a step)")
    peak = [r["max_memory_allocated"] for r in result["ranks"]]
    out["bench"] = {
        "batch": BENCH_BATCH, "step_ms": ms,
        "samples_per_s": BENCH_BATCH * 1e3 / statistics.mean(ms[1:]),
        "grad_all_reduces": reduces, "max_memory_allocated": peak,
        "validation": [ln for ln in text.splitlines() if ln.startswith("validation")]}
    for ln in text.splitlines():
        if re.match(r"data:|validation|The number|\(epoch", ln):
            print(f"  dp cli: {ln}")
    shared = ("" if torch.cuda.device_count() >= DP_RANKS else
              f"; {DP_RANKS} ranks share this one card over gloo: a smoke reading, not a "
              "multi-card speed")
    print(f"data-parallel pix2pix bench configuration, --data_mesh {DP_RANKS}, global batch "
          f"{BENCH_BATCH}, 256x256 bf16, dropout on: ms/step {ms} (step 1 warms up), "
          f"{out['bench']['samples_per_s']:.1f} samples/s over steps 2-{DP_STEPS}; the grads' "
          f"all-reduces per rank {reduces}; max_memory_allocated per rank "
          f"{[round(p / 2**30, 2) for p in peak]} GiB on {name}{shared}")

    # (b) step 1 held, f32
    out["held"], fails = dp_held_steps(torch, work)

    # (c) CycleGAN at its defaults under --data_mesh 2 on the kernel
    # routes: every rank launches each route's kernels as one card does
    # per step at batch 1, every bf16 call on its wgmma kernel or on the
    # path its plan names
    out["cyclegan"] = {}
    for route in DP_CG_ROUTES:
        log = io.StringIO()
        zero_counts()
        torch.cuda.empty_cache()
        with contextlib.redirect_stdout(log):
            result = train.main(train_argv(route, "bfloat16", work, f"dp_{route}",
                                           extra=DP_CG_FLAGS))
        lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("(epoch:")]
        check(len(lines) == DP_CG_STEPS and not any("nan" in ln or "inf" in ln
                                                    for ln in lines),
              f"data-parallel CycleGAN {route}: loss lines {lines}")
        check(result["params_equal"], f"data-parallel CycleGAN {route}: the ranks' state "
              "differs")
        per_step = with_path_counts(TRAIN_ROUTES[route][1], "bfloat16",
                                    NORM_CALLS.get(route, ()))
        for r, counts in enumerate(result["launches"]):
            want = {k: per_step.get(k, 0) * DP_CG_STEPS for k in counts}
            check(counts == want, f"data-parallel CycleGAN {route}: rank {r} launches "
                  f"{ {k: v for k, v in counts.items() if v} }, expected "
                  f"{ {k: v for k, v in want.items() if v} }")
        out["cyclegan"][route] = {"flags": TRAIN_ROUTES[route][0] + DP_CG_FLAGS,
                                  "launches": result["launches"],
                                  "step_ms": result["step_ms"]}
        nonzero = [{k: v for k, v in c.items() if v} for c in result["launches"]]
        print(f"data-parallel CycleGAN {route}, {DP_CG_STEPS} bf16 steps of global batch "
              f"{DP_RANKS}: launches per rank {nonzero}; rank 0 ms/step {result['step_ms']}")

    # (d) the metric bundle, card against CPU
    out["metrics"] = dp_metrics(torch)
    check(not fails, "; ".join(fails))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"data-parallel phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# sharded pix2pix and the 2-D mesh: --spatial_mesh 2, --data_mesh 2 --spatial_mesh 2
# ---------------------------------------------------------------------------

SP_RANKS = 2
SP_CROP = 512  # the least W at which unet_256's eight downs split over two shards
SP_FLAGS = ["--spatial_mesh", str(SP_RANKS), "--w_pad_mode", "wrap"]
SP_STEPS = 3  # the bench configuration's CLI steps; ms/step over steps 2-3
SP_ROUTE_STEPS = 2
MESH_FLAGS = ["--data_mesh", "2", "--spatial_mesh", "2", "--w_pad_mode", "wrap"]
MESH_BATCH, MESH_STEPS = 2, 3  # global batch 2: one sample a data row
MESH_CG_STEPS = 2
CG_MESH_STEP = {"conv3x3_fused": 54, "conv3x3_fused_t": 54, "conv3x3_fused_bwd": 54}


def mesh_cli(torch, argv, steps, what) -> tuple:
    """``train.main`` on ranks; every launch count set to 0 just before and
    read just after (the ranks count their own). Returns (rank 0's result,
    the log). Fails on a missing or non-finite loss line or ranks that
    ended unequal."""
    from biasgan_tpu_torch import train

    log = io.StringIO()
    zero_counts()
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(log):
        result = train.main(argv)
    text = log.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("(epoch:")]
    check(len(lines) == steps and not any("nan" in ln or "inf" in ln for ln in lines),
          f"{what}: loss lines {lines}, expected {steps} finite")
    check(result["params_equal"], f"{what}: the ranks' state differs")
    for ln in text.splitlines():
        if re.match(r"(spatial|mesh):|--\w|validation|\(epoch", ln) and "launches" not in ln:
            print(f"  {what}: {ln}")
    return result, text


def held_pair(got, ref, moved_got, moved_ref, what, dtype="float32"):
    """``got`` held to ``ref`` by phase 7's rules, the noise floor the
    larger of the two sides' own moves (phase 9)."""
    floor_got = grad_distance(moved_got, got)[1]
    floor_ref = grad_distance(moved_ref, ref)[1]
    floor = {net: max(floor_got[net], floor_ref[net]) for net in floor_ref}
    held = hold_first_step(what, dtype, got, ref, floor)
    print(f"{what}: losses {got['losses']} vs {ref['losses']}; relative L2 per net "
          f"{held['grad_rel_l2']} (noise floor {floor})")
    return {"losses": got["losses"], "losses_ref": ref["losses"],
            "grad_rel_l2": held["grad_rel_l2"], "noise_floor": floor}, held["fails"]


def mesh_held(torch, work, argv, cases, n, fn=None):
    """Step 1 of each case on ``n`` card ranks (``train_cases``, or
    ``data_cases`` with ``fn=dp_rank``): {tag: {"losses", "G", "D"}} from
    the saved gradients, and each rank's launches."""
    from biasgan_tpu_torch.parallel import spawn

    for c in cases:
        c["grads"] = os.path.join(work, f"mesh_grads_{c['tag']}.pt")
    t0 = time.perf_counter()
    if fn is None:
        res = spawn(sharded_train_rank, n, (argv, cases), device="cuda", timeout=600,
                    group_timeout=600)
    else:
        res = spawn(fn, n, (cases,), device="cuda", timeout=600, group_timeout=600)
    print(f"  {len(cases)} held steps on {n} ranks ({time.perf_counter() - t0:.1f} s)")
    out = {}
    for c, r in zip(cases, res):
        check(r["params_equal"], f"{c['tag']}: the ranks' state differs after step 1")
        out[c["tag"]] = {"losses": r["losses"][0], "launches": r["launches"],
                         **torch.load(c["grads"], weights_only=True)}
    return out


def mesh_phase(torch, work) -> dict:
    """The sharded pix2pix step and the 2-D mesh on the card (module
    docstring, phase 11): (a) the bench configuration at 512^2 through
    ``train.main --spatial_mesh 2``; (b) its f32 step 1 with dropout on
    held to one card's; (c) the resnet route's K2 launches in the halo W
    mode, its step 1 held to the plain sharded step; (d) the 2-D mesh at
    512^2, its f32 step 1 held to --data_mesh 2's; (e) CycleGAN on the 2-D
    mesh with K2's launches."""
    from biasgan_tpu_torch.parallel import placement

    t_phase = time.perf_counter()
    name = card()
    dev = torch.device("cuda")
    out = {"card": name}
    fails = []
    shared = ("" if torch.cuda.device_count() >= 4 else
              "; the ranks share this one card over gloo: a smoke reading, not a multi-card "
              "speed")

    # (a) the bench configuration at 512^2 over two W shards, bf16, batch 1
    argv = p2p_argv(work, "sp_bench", "--crop_size", str(SP_CROP), "--compute_dtype",
                    "bfloat16", "--synthetic_samples", str(SP_STEPS), "--device", "cuda",
                    *SP_FLAGS)
    result, _ = mesh_cli(torch, argv, SP_STEPS, "sharded pix2pix")
    check(not any(v for c in result["launches"] for v in c.values()),
          f"sharded pix2pix: kernel launches {result['launches']}")
    ms, peak = result["step_ms"], [r["max_memory_allocated"] for r in result["ranks"]]
    out["spatial"] = {"crop": SP_CROP, "step_ms": ms, "ms_per_step": statistics.mean(ms[1:]),
                      "max_memory_allocated": peak}
    print(f"sharded pix2pix bench configuration, {SP_CROP}x{SP_CROP} batch 1 bf16, dropout "
          f"on, --spatial_mesh {SP_RANKS}: rank 0 ms/step {ms} (step 1 warms up; mean of the "
          f"rest {out['spatial']['ms_per_step']:.1f}); max_memory_allocated per rank "
          f"{[round(p / 2**30, 2) for p in peak]} GiB on {name}{shared}")

    # (b) f32 step 1, dropout on, at 512^2: the two ranks against one card;
    # (c) the resnet route's step 1 against the plain sharded step, bf16
    f32 = ["--crop_size", str(SP_CROP), "--synthetic_samples", "1"]
    route = P2P_PLAIN + ["--compute_dtype", "bfloat16", "--synthetic_samples", "1"]
    cases = [dict(flags=f32 + ["--gan_mode", mode], steps=1, perturb=p,
                  tag=f"sp_{mode}_{'moved' if p else 'ref'}")
             for mode in ("vanilla", "wgangp") for p in (0.0, NOISE_INPUT["float32"])]
    cases += [dict(flags=route, steps=1, tag="sp_route_plain"),
              dict(flags=route + ["--fused_blocks"], steps=1, tag="sp_route_fused")]
    held = mesh_held(torch, work, P2P_ARGS + SP_FLAGS + [
        "--checkpoints_dir", os.path.join(work, "sp_held"), "--device", "cuda"], cases,
        SP_RANKS)
    out["held"] = {}
    for mode in ("vanilla", "wgangp"):
        argv = p2p_argv(work, f"sp_one_{mode}", *f32, "--gan_mode", mode, "--w_pad_mode",
                        "wrap")
        one = p2p_first_step(torch, dev, argv)
        moved = p2p_first_step(torch, dev, argv, perturb=NOISE_INPUT["float32"])
        out["held"][mode], f = held_pair(
            held[f"sp_{mode}_ref"], one, held[f"sp_{mode}_moved"], moved,
            f"sharded pix2pix {mode} f32 step 1, dropout on, 2 card ranks vs one card")
        fails += f
    want = {k: v for k, v in with_path_counts(P2P_ROUTE_STEP, "bfloat16").items() if v}
    for r, counts in enumerate(held["sp_route_fused"]["launches"]):
        counts = {k: v for k, v in counts.items() if v}
        check(counts == want, f"sharded pix2pix --fused_blocks step 1: rank {r} launches "
              f"{counts}, expected {want}")
    argv = p2p_argv(work, "sp_route_one", *route, "--w_pad_mode", "wrap")
    one = p2p_first_step(torch, dev, argv)
    floor = grad_distance(p2p_first_step(torch, dev, argv, perturb=NOISE_INPUT["bfloat16"]),
                          one)[1]
    h = hold_first_step("sharded pix2pix --fused_blocks", "bfloat16", held["sp_route_fused"],
                        held["sp_route_plain"], floor)
    fails += h["fails"]
    print(f"sharded pix2pix resnet_9blocks --fused_blocks bf16 step 1 held to the plain "
          f"sharded step: relative L2 per net {h['grad_rel_l2']} (noise floor {floor})")
    argv = p2p_argv(work, "sp_route", *P2P_ROUTE, "--compute_dtype", "bfloat16",
                    "--synthetic_samples", str(SP_ROUTE_STEPS), "--device", "cuda", *SP_FLAGS)
    result, _ = mesh_cli(torch, argv, SP_ROUTE_STEPS, "sharded pix2pix --fused_blocks")
    want = {k: v * SP_ROUTE_STEPS for k, v in want.items()}
    for r, counts in enumerate(result["launches"]):
        counts = {k: v for k, v in counts.items() if v}
        check(counts == want, f"sharded pix2pix --fused_blocks CLI: rank {r} launches "
              f"{counts}, expected {want}")
    out["route"] = {"launches_per_rank": result["launches"], "grad_rel_l2": h["grad_rel_l2"],
                    "noise_floor": floor, "step_ms": result["step_ms"]}
    print(f"sharded pix2pix --fused_blocks CLI, {SP_ROUTE_STEPS} bf16 steps: K2 per rank "
          f"{[{k: c[k] for k in want} for c in result['launches']]}")

    # (d) the 2-D mesh at 512^2, global batch 2, bf16, with validation
    print(placement(4, "cuda", kind="mesh", spatial=2))
    out["mesh"] = mesh_2d_bench(torch, work)
    # its f32 step 1, dropout on, against --data_mesh 2 on the card
    f32 = ["--crop_size", str(SP_CROP), "--batch_size", str(MESH_BATCH),
           "--synthetic_samples", str(MESH_BATCH), "--w_pad_mode", "wrap"]
    base = P2P_ARGS + f32 + ["--checkpoints_dir", os.path.join(work, "mesh_held"),
                             "--device", "cuda"]
    mesh = mesh_held(torch, work, base + MESH_FLAGS,
                     [dict(flags=[], steps=1, perturb=p, tag=f"mesh_{'moved' if p else 'ref'}")
                      for p in (0.0, NOISE_INPUT["float32"])], 4)
    dp_argv = base + ["--data_mesh", "2", "--name", "dp"]
    dp = mesh_held(torch, work, None,
                   [{"argv": dp_argv, "batches": [dp_first_batch(dp_argv, p)],
                     "tag": f"dp_{'moved' if p else 'ref'}"}
                    for p in (0.0, NOISE_INPUT["float32"])], 2, fn=dp_rank)
    out["mesh"]["held"], f = held_pair(
        mesh["mesh_ref"], dp["dp_ref"], mesh["mesh_moved"], dp["dp_moved"],
        "2-D mesh pix2pix f32 step 1, dropout on, 4 card ranks vs --data_mesh 2")
    fails += f

    # (e) CycleGAN at its defaults on the 2-D mesh, --fused_blocks, bf16
    argv = train_argv("fused", "bfloat16", work, "mesh_cg", extra=MESH_FLAGS + [
        "--batch_size", str(MESH_BATCH), "--synthetic_samples", str(MESH_BATCH * MESH_CG_STEPS)])
    result, _ = mesh_cli(torch, argv, MESH_CG_STEPS, "2-D mesh CycleGAN --fused_blocks")
    want = {k: v * MESH_CG_STEPS
            for k, v in with_path_counts(CG_MESH_STEP, "bfloat16").items() if v}
    for r, counts in enumerate(result["launches"]):
        counts = {k: v for k, v in counts.items() if v}
        check(counts == want, f"2-D mesh CycleGAN: rank {r} launches {counts}, expected {want}")
    out["cyclegan"] = {"launches_per_rank": result["launches"], "step_ms": result["step_ms"]}
    print(f"2-D mesh CycleGAN --fused_blocks, {MESH_CG_STEPS} bf16 steps of global batch "
          f"{MESH_BATCH}: K2 per rank {[{k: c[k] for k in want} for c in result['launches']]}; "
          f"rank 0 ms/step {result['step_ms']}")
    check(not fails, "; ".join(fails))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"sharded pix2pix and 2-D mesh phase: {out['seconds']:.1f} s")
    return out


def mesh_2d_bench(torch, work) -> dict:
    """(d)'s CLI run: the bench configuration at 512^2 through ``train.main
    --data_mesh 2 --spatial_mesh 2`` (a card per rank where the host has
    four, else the ranks share them over gloo), global batch 2, bf16,
    dropout on, --val_split 2 --val_freq 2: both validation lines, no
    kernel, every rank bitwise equal; rank 0's ms/step, and each rank's
    count of the grads' all-reduces (G and D a step) and its peak memory."""
    name = card()
    argv = p2p_argv(work, "mesh_bench", "--crop_size", str(SP_CROP), "--batch_size",
                    str(MESH_BATCH), "--compute_dtype", "bfloat16", "--synthetic_samples",
                    str(MESH_BATCH * (MESH_STEPS + 1)), "--val_split", str(MESH_BATCH),
                    "--val_freq", str(MESH_BATCH), "--device", "cuda", *MESH_FLAGS)
    result, text = mesh_cli(torch, argv, MESH_STEPS, "2-D mesh pix2pix")
    for want in ("validation (train batch):", "validation (held out):",
                 "mesh: parameters bitwise equal on every rank: True"):
        check(want in text, f"2-D mesh pix2pix: no line {want!r}")
    check(not any(v for c in result["launches"] for v in c.values()),
          f"2-D mesh pix2pix: kernel launches {result['launches']}")
    ms = result["step_ms"]
    reduces = [r["grad_reduces"] for r in result["ranks"]]
    check(reduces == [2 * MESH_STEPS] * len(reduces),
          f"2-D mesh pix2pix: grads' all-reduces per rank {reduces}, expected "
          f"{2 * MESH_STEPS} (G and D a step)")
    peak = [r["max_memory_allocated"] for r in result["ranks"]]
    backend = re.search(r"backend (\w+)", text).group(1)
    print(f"2-D mesh pix2pix bench configuration, data 2 x spatial 2, {SP_CROP}x{SP_CROP} "
          f"global batch {MESH_BATCH} bf16, dropout on, {backend}: rank 0 ms/step {ms} (step 1 "
          f"warms up); the grads' all-reduces per rank {reduces}; "
          f"max_memory_allocated per rank {[round(p / 2**30, 2) for p in peak]} GiB on {name}")
    return {"backend": backend, "step_ms": ms, "ms_per_step": statistics.mean(ms[1:]),
            "grad_all_reduces": reduces, "max_memory_allocated": peak,
            "validation": [ln for ln in text.splitlines() if ln.startswith("validation")],
            "card": name}


# ---------------------------------------------------------------------------
# the test driver and the image datasets
# ---------------------------------------------------------------------------

TD_SIZE = 256
TD_IMAGES = {"trainA": 4, "testA": 4, "trainB": 3}
TD_TRAIN_STEPS = 2
TD_TRAIN = ["--model", "cycle_gan", "--seed", "0", "--netG", "resnet_9blocks", "--ngf", "64",
            "--ndf", "64",
            "--load_size", str(TD_SIZE), "--crop_size", str(TD_SIZE),
            "--max_dataset_size", str(TD_TRAIN_STEPS), "--n_epochs", "1", "--n_epochs_decay", "0",
            "--print_freq", "1", "--display_freq", "1", "--check_finite", "1",
            "--save_epoch_freq", "1", "--save_latest_freq", "1000000", "--fused_blocks",
            "--compute_dtype", "bfloat16", "--device", "cuda"]
# the instance norms of one resnet_9blocks forward at 256x256 outside the
# blocks: the stem's and up1's (64 channels), down0's and up0's (128 at
# 128x128), down1's (256 at 64x64); --force_pallas_norm alone adds the
# blocks' 18 at 64x64x256
_TD_NORMS = [((1, 256, 256, 64), 2), ((1, 128, 128, 128), 2), ((1, 64, 64, 256), 1)]
# test driver route -> (flags, launches per image, the instance norms' calls)
TD_ROUTES = {
    "plain": ([], {}, ()),
    # the reference's default, a training-mode forward: the fused down / up
    # kernels have no training-mode path, so the five outer norms take K7
    "all": (["--fused_blocks", "--fused_updown", "--conv7_pallas", "1", "--force_pallas_norm"],
            {"conv3x3_fused": 18, "conv7x7": 2, "instance_norm_act": 5}, _TD_NORMS),
    # --eval: every norm rides in a conv kernel (K4 and K5 take the outer ones)
    "all_eval": (["--fused_blocks", "--fused_updown", "--conv7_pallas", "1",
                  "--force_pallas_norm", "--eval"],
                 {"conv3x3_fused": 18, "conv7x7": 2, "conv3x3s2_fused": 2,
                  "convt3x3s2_fused": 2}, ()),
    "norm": (["--force_pallas_norm"], {"instance_norm_act": 23},
             _TD_NORMS[:2] + [((1, 64, 64, 256), 19)]),
    "valid": (["--pallas_conv", "1"], {"conv3x3_valid": 18}, ()),
}
TD_UNET = ["--model", "pix2pix", "--netG", "unet_256", "--norm", "batch", "--ngf", "64",
           "--input_nc", "3", "--output_nc", "3", "--load_size", str(TD_SIZE),
           "--crop_size", str(TD_SIZE), "--compute_dtype", "bfloat16", "--device", "cuda"]


def write_images(root: str) -> None:
    """TD_IMAGES' directories of smooth random RGB PNGs (TD_SIZE square),
    and test/ with one aligned A|B image twice (two names)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(3)

    def image(w):
        low = rng.random((8, w // TD_SIZE * 8, 3))
        up = np.kron(low, np.ones((TD_SIZE // 8, TD_SIZE // 8, 1)))
        return Image.fromarray((up * 255).astype(np.uint8))

    for d, n in TD_IMAGES.items():
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            image(TD_SIZE).save(os.path.join(root, d, f"{d}_{i}.png"))
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    ab = image(2 * TD_SIZE)
    for i in range(2):
        ab.save(os.path.join(root, "test", f"ab_{i}.png"))


def drive_test(torch, argv, pages: bool):
    """``biasgan_tpu_torch.test`` on ``argv`` (its parse, config dump and
    checkpoint check, then its loop), every launch count set to 0 just
    before and read just after. Returns (launches, the loop's result, each
    sample's visuals on the host)."""
    from biasgan_tpu_torch import test as driver

    visuals = []
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        cfg = driver.prepare(argv)
        res = driver.run(cfg, torch.device("cuda"), pages=pages, on_sample=lambda i, v, p:
                         visuals.append({k: t.float().cpu() for k, t in v.items()}))
    torch.cuda.synchronize()
    return read_counts(), res, visuals


def test_driver_phase(torch, work) -> dict:
    """The test driver and the image datasets on the card (module
    docstring, phase 12): CycleGAN trained at its defaults on PNG
    directories; its G_A through ``biasgan_tpu_torch.test --model test``
    on the kernel and plain routes; the bench configuration's U-Net with
    and without --eval."""
    import importlib.util

    import numpy as np

    from biasgan_tpu_torch import train

    t_phase = time.perf_counter()
    name = card()
    pil = importlib.util.find_spec("PIL") is not None
    root = os.path.join(work, "images")
    ck = os.path.join(work, "test_driver")
    out = {"card": name, "pil": pil}
    if pil:
        write_images(root)
        data = ["--dataroot", root]
    else:
        print("  pages: not written (no Pillow on this host); the image datasets give way to "
              "--dataset_mode synthetic")
        data = ["--dataset_mode", "synthetic", "--synthetic_samples", str(TD_TRAIN_STEPS)]

    # (a) CycleGAN at its defaults (resnet_9blocks, instance norm, unaligned
    # data), --fused_blocks, bf16, two steps
    log = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state = train.main(TD_TRAIN + data + ["--checkpoints_dir", ck, "--name", "cg"])
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    counts = read_counts()
    per_step = with_path_counts(TRAIN_ROUTES["fused"][1], "bfloat16")
    want = {k: per_step.get(k, 0) * TD_TRAIN_STEPS for k in counts}
    check(counts == want, f"CycleGAN on unaligned: launches {counts}, expected {want}")
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("(epoch:")]
    check(len(lines) == TD_TRAIN_STEPS and not any("nan" in ln or "inf" in ln for ln in lines),
          f"CycleGAN on unaligned: loss lines {lines}")
    check(("dataset_mode: unaligned" in log.getvalue()) == pil, "CycleGAN: not on unaligned")
    if pil:
        imgs = os.listdir(os.path.join(ck, "cg", "web", "images"))
        check(len(imgs) == 6 and os.path.exists(os.path.join(ck, "cg", "web", "index.html")),
              f"CycleGAN --display_freq 1: pages {imgs}")
    out["train"] = {"launches": {k: v for k, v in counts.items() if v}, "loss_lines": lines}
    print(f"CycleGAN at its defaults on {'unaligned PNGs' if pil else 'synthetic data'}, "
          f"--fused_blocks bf16, {TD_TRAIN_STEPS} steps in {out['train_s']:.1f} s: "
          f"{lines[-1]}; launches {out['train']['launches']}")
    del state
    torch.cuda.empty_cache()

    # (b) its G_A through the test driver, --model test --model_suffix _A
    single = (["--dataset_mode", "single", "--dataroot", os.path.join(root, "testA")] if pil
              else ["--dataset_mode", "synthetic", "--synthetic_samples", "4"])
    base = ["--model", "test", "--model_suffix", "_A", "--netG", "resnet_9blocks",
            "--ngf", "64", "--norm", "instance", "--no_dropout", "--load_size", str(TD_SIZE),
            "--crop_size", str(TD_SIZE), "--compute_dtype", "bfloat16",
            "--checkpoints_dir", ck, "--name", "cg", "--device", "cuda"] + single
    n_img = TD_IMAGES["testA"]
    served = {}
    for dtype in ("float32", "bfloat16"):
        for route, (flags, per_image, norms) in TD_ROUTES.items():
            res_dir = os.path.join(work, f"results_td_{route}_{dtype}")
            argv = base + flags + ["--compute_dtype", dtype, "--results_dir", res_dir]
            counts, res, vis = drive_test(torch, argv, pil)
            check(len(vis) == n_img, f"test driver {route} {dtype}: {len(vis)} samples")
            want = with_path_counts(per_image, dtype, norms)
            want = {k: want.get(k, 0) * n_img for k in counts}
            check(counts == want, f"test driver {route} {dtype}: launches {counts}, expected "
                  f"{want}")
            for v in vis:
                check(v["fake"].shape == (1, TD_SIZE, TD_SIZE, 3)
                      and bool(torch.isfinite(v["fake"]).all()),
                      f"test driver {route} {dtype}: fake")
            if pil:
                web = res["web_dir"]
                pngs = sorted(os.listdir(os.path.join(web, "images")))
                check(len(pngs) == 2 * n_img and os.path.exists(os.path.join(web, "index.html")),
                      f"test driver {route} {dtype}: page images {pngs}")
            served[route, dtype] = ([v["fake"].numpy() for v in vis], res["ms"],
                                    {k: v for k, v in counts.items() if v})

    def against(fakes, ref):
        """(the worst margin to the globe rule |dy| <= 0.02 |y| + 0.1 std,
        the largest max |dy| / std, the largest mean |dy| / std) over the
        images, std each reference image's."""
        std = [float(r.std()) for r in ref]
        diffs = [np.abs(f - r) for f, r in zip(fakes, ref)]
        return (max(float((d - (0.02 * np.abs(r) + 0.1 * s)).max())
                    for d, r, s in zip(diffs, ref, std)),
                max(float(d.max()) / s for d, s in zip(diffs, std)),
                max(float(d.mean()) / s for d, s in zip(diffs, std)))

    # f32: each kernel route within the globe rule of plain (phase 6's).
    # bf16: plain's own rounding already breaks that rule at these images
    # (the first chip run of this phase: plain bf16 against plain f32,
    # margin 0.0324, mean |dy| 0.0181 std), so each bf16 route is held to
    # plain f32 by the noise-floor rule of phase 7: its max and mean |dy|
    # at most NOISE_FACTOR times plain bf16's own
    fails = []
    ref32 = served["plain", "float32"][0]
    floor = against(served["plain", "bfloat16"][0], ref32)
    out["bf16_floor"] = {"max_dy_std": floor[1], "mean_dy_std": floor[2]}
    for (route, dtype), (fakes, ms, launches) in served.items():
        line = {"ms_per_image": ms, "launches": launches}
        if dtype == "float32" and route != "plain":
            line["worst_margin"], _, line["mean_dy_std"] = against(fakes, ref32)
            if line["worst_margin"] > 0 or line["mean_dy_std"] > 0.01:
                fails.append(f"{route} f32 vs plain: margin {line['worst_margin']:.4g}, mean "
                             f"|dy| {line['mean_dy_std']:.4g} std")
            held = (f"vs plain f32: worst margin {line['worst_margin']:.4g}, mean |dy| "
                    f"{line['mean_dy_std']:.4g} std")
        elif dtype == "bfloat16":
            _, line["max_dy_std"], line["mean_dy_std"] = against(fakes, ref32)
            held = (f"vs plain f32: max |dy| {line['max_dy_std']:.4g}, mean |dy| "
                    f"{line['mean_dy_std']:.4g} std")
            if route != "plain":
                held += f" (limit {NOISE_FACTOR:g} x plain bf16's)"
                if (line["max_dy_std"] > NOISE_FACTOR * floor[1]
                        or line["mean_dy_std"] > NOISE_FACTOR * floor[2]):
                    fails.append(f"{route} bf16: {held}: {floor[1]:.4g}, {floor[2]:.4g}")
        else:
            held = "the reference"
        out[f"test_{route}_{dtype}"] = line
        print(f"test driver --model test _A resnet_9blocks {TD_SIZE}x{TD_SIZE} {dtype} {route}: "
              f"ms/image {[round(m, 3) for m in ms]} (image 0 warms up; median of the rest "
              f"{statistics.median(ms[1:]):.3f}), launches {launches}, {held} on {name}")
    check(not fails, "test driver fakes disagree: " + "; ".join(fails))

    # (c) the bench configuration's U-Net from a one-step checkpoint
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(P2P_ARGS + ["--compute_dtype", "bfloat16", "--synthetic_samples", "1",
                               "--save_epoch_freq", "1", "--checkpoints_dir", ck,
                               "--name", "p2p", "--device", "cuda"])
    saved = torch.load(os.path.join(ck, "p2p", "latest_net_G.pth"), weights_only=True)
    aligned = (["--dataset_mode", "aligned", "--dataroot", root] if pil else
               ["--dataset_mode", "synthetic", "--synthetic_samples", "2", "--seed", "0"])
    unet = TD_UNET + aligned + ["--checkpoints_dir", ck, "--name", "p2p", "--results_dir",
                                os.path.join(work, "results_td_unet")]
    counts, res, vis = drive_test(torch, unet, pil)
    check(not any(counts.values()), f"test driver U-Net: launches {counts}, expected none")
    G = res["state"].nets["G"]
    same = all(torch.equal(t.cpu(), saved[k]) for k, t in G.state_dict().items())
    check(same, "test driver U-Net without --eval: G's running averages moved")
    moved = float((vis[0]["fake_B"] - vis[1]["fake_B"]).abs().max())
    if pil:  # one image twice: only the dropout masks differ
        check(torch.equal(vis[0]["real_A"], vis[1]["real_A"]) and moved > 0,
              f"test driver U-Net without --eval: two forwards of one image differ by {moved}")
    evals = [drive_test(torch, unet + ["--eval"], pil)[2] for _ in range(2)]
    check(all(torch.equal(a["fake_B"], b["fake_B"]) for a, b in zip(*evals)),
          "test driver U-Net --eval: two runs differ")
    out["unet"] = {"ms_per_image_train_mode": res["ms"], "train_mode_dropout_max_dy": moved,
                   "running_averages_unchanged": same}
    print(f"test driver pix2pix unet_256 (batch norm, dropout) bf16: without --eval the two "
          f"forwards of one image differ by max |dy| {moved:.4g}, G's running averages "
          f"bitwise unchanged: {same}; with --eval two runs bitwise equal; ms/image "
          f"{[round(m, 3) for m in res['ms']]} on {name}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 12 (test driver and image datasets): {out['phase_s']:.1f} s")
    return out



# ---------------------------------------------------------------------------
# K steps a call, the bf16 Adam moment, the threaded loader, K-step calls on
# the meshes
# ---------------------------------------------------------------------------

SPC_K, SPC_CALLS = 4, 3  # bench.py's BENCH_SCAN = 4 steps a call; three calls
SPC_HELD_BATCH = 2  # the held K=2 pix2pix call's batch
MU_STEPS = 3
LOADER_EPOCHS = 3
LOADER_THREADS = 4


def spc_stack(torch, k, batch_size, seed=1):
    """k seeded batches of the bench configuration's fields (256x256, 3
    channels), stacked (k, B, ...) on the card."""
    a = torch.randn((k, batch_size, 256, 256, 3), generator=torch.Generator().manual_seed(seed))
    return {"A": a.cuda(), "B": torch.tanh(a).cuda()}


def moved_stack(torch, stack, perturb):
    """``stack`` with its first batch's A and B moved by ``perturb``
    relative noise (the noise floor)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    out = {k: v.clone() for k, v in stack.items()}
    for k in ("A", "B"):
        x = out[k][0]
        x.mul_(1 + perturb * torch.randn(x.shape, generator=g, device="cuda"))
    return out


def held_call(torch, cfg, stack, k, singles: bool) -> dict:
    """From the seeded state, the stack's k steps as one K-step call
    (``make_scan_step``) or as k single steps with the same step
    generators. Returns each step's losses ({name@step: float}) and, as
    phase 7 holds them, the last step's gradients: CycleGAN's from its
    step (``debug_grads``), pix2pix's from Adam's first moments after the
    steps, mu / (1 - b1), a mix of the steps' gradients."""
    from biasgan_tpu_torch.models.common import make_scan_step, step_generator
    from biasgan_tpu_torch.registry import get_model

    entry = get_model(cfg.model)
    state = entry.create_state(cfg, torch.device("cuda"))
    kw = {"debug_grads": True} if cfg.model == "cycle_gan" else {}
    step = entry.make_train_step(cfg, **kw)
    if singles:
        out = [step(state, {n: v[i] for n, v in stack.items()}, step_generator(cfg.seed, i))
               for i in range(k)]
        losses = [{n: float(v) for n, v in ls.items()} for ls, _ in out]
        vis = out[-1][1]
    else:
        ls, vis = make_scan_step(step, k, cfg.seed)(state, stack, 0)
        losses = [{n: float(v[i]) for n, v in ls.items()} for i in range(k)]
    torch.cuda.synchronize()
    res = {"losses": {f"{n}@{i + 1}": v for i, ls in enumerate(losses) for n, v in ls.items()}}
    if cfg.model == "cycle_gan":
        res.update(G=vis["_g_grads"], D=vis["_d_grads"])
    else:
        res.update({net: {n: (t.float() / (1 - o.b1)).cpu() for n, t in o.mu.items()}
                    for net, o in state.opts.items()})
    del state, vis
    return res


def spc_held(torch, what, cfg, stack, k):
    """The K-step call held to k single steps by phase 7's rules, the
    noise floor the single steps' own move on inputs moved by a bf16 ulp.
    Returns (the result, with the call's launches, every count set to 0
    just before it; the fails)."""
    zero_counts()
    got = held_call(torch, cfg, stack, k, singles=False)
    counts = read_counts()
    ref = held_call(torch, cfg, stack, k, singles=True)
    floor = grad_distance(held_call(torch, cfg, moved_stack(torch, stack,
                                                            NOISE_INPUT["bfloat16"]), k,
                                    singles=True), ref)[1]
    held = hold_first_step(what, "bfloat16", got, ref, floor)
    print(f"{what}: one call of {k} steps vs {k} single steps: losses {got['losses']} vs "
          f"{ref['losses']}; relative L2 per net {held['grad_rel_l2']} (noise floor {floor})")
    return {"grad_rel_l2": held["grad_rel_l2"], "noise_floor": floor,
            "worst_grad_err": held["worst_grad_err"], "launches": counts}, held["fails"]


def sync_sites(torch, fn) -> dict:
    """``fn()`` under ``torch.cuda.set_sync_debug_mode('warn')``: the
    synchronizing calls made inside it, counted by the innermost frame of
    this checkout that made each (a warning raised outside ``fn``'s frame,
    by the mode's switch, is not counted)."""
    import traceback
    import warnings

    sites = {}
    code = fn.__code__

    def seen(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not f.filename.endswith("warnings.py")]
        inside = any(f.filename == code.co_filename and f.name == code.co_name
                     for f in frames)
        if "synchroniz" not in str(message) or not inside:
            return
        mine = [f for f in frames if f.filename.startswith(HERE)] or frames
        where = f"{os.path.relpath(mine[-1].filename, HERE)}:{mine[-1].lineno}"
        sites[where] = sites.get(where, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def steps_per_call_phase(torch, work, bench_k1) -> dict:
    """K steps a call and the rest of the slice (module docstring, phase
    13): (a) the bench configuration at batch 128, --steps_per_call 4; (b)
    CycleGAN on the all-kernel route, --steps_per_call 2; (c) the bf16 Adam
    moment; (d) the threaded loader on the NetCDF store; (e) K-step calls
    under --data_mesh 2 and on the 2-D mesh. ``bench_k1``: phase 9's
    reading at one step a call."""
    import numpy as np

    from biasgan_tpu_torch import train
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.data import create_dataset
    from biasgan_tpu_torch.models.common import make_scan_step, step_generator
    from biasgan_tpu_torch.models.pix2pix import create_state, make_train_step

    t_phase = time.perf_counter()
    name = card()
    dev = torch.device("cuda")
    out = {"card": name}
    fails = []

    # (a) the slice's path: one K=4 call of the bench configuration at
    # batch 128 on a stack on the card, timed, then one call under the sync
    # debug mode
    cfg = parse_config(p2p_argv(work, "spc_bench", "--batch_size", str(BENCH_BATCH),
                                "--compute_dtype", "bfloat16", "--no-in_graph_aug",
                                "--steps_per_call", str(SPC_K), "--device", "cuda"), train=True)
    cfg.steps_per_epoch = 1000
    stack = spc_stack(torch, SPC_K, BENCH_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = create_state(cfg, dev)
    call = make_scan_step(make_train_step(cfg), SPC_K, cfg.seed)
    ms = []
    for c in range(SPC_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, _ = call(state, stack, c * SPC_K)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(all(v.shape == (SPC_K,) and bool(torch.isfinite(v).all())
                  for v in losses.values()), f"pix2pix K={SPC_K} call {c + 1}: losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    sites = sync_sites(torch, lambda: call(state, stack, SPC_CALLS * SPC_K))
    del state, call, losses
    per_step = [m / SPC_K for m in ms]
    k1 = bench_k1["step_ms"]
    out["bench"] = {"batch": BENCH_BATCH, "steps_per_call": SPC_K, "call_ms": ms,
                    "ms_per_step": per_step,
                    "samples_per_s": BENCH_BATCH * 1e3 / statistics.mean(per_step[1:]),
                    "max_memory_allocated": peak, "syncs_per_call": sum(sites.values()),
                    "sync_sites": sites, "k1_step_ms": k1,
                    "k1_samples_per_s": bench_k1["samples_per_s"],
                    "k1_max_memory_allocated": bench_k1["max_memory_allocated"]}
    print(f"pix2pix bench configuration, batch {BENCH_BATCH}, 256x256 bf16, dropout on, "
          f"--steps_per_call {SPC_K}: ms/call {[round(m, 3) for m in ms]} (call 1 warms up), "
          f"ms/step {[round(m, 3) for m in per_step]}, {out['bench']['samples_per_s']:.1f} "
          f"samples/s over calls 2-{SPC_CALLS}, max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"beside phase 9's one step a call: ms/step {[round(m, 3) for m in k1]}, "
          f"{bench_k1['samples_per_s']:.1f} samples/s, "
          f"{bench_k1['max_memory_allocated'] / 2**30:.2f} GiB; synchronizing calls in one "
          f"K={SPC_K} call (set_sync_debug_mode 'warn'): {sum(sites.values())} {sites} on {name}")
    torch.cuda.empty_cache()

    # ... and through the CLI: three calls of 4 steps, the loader's threads
    # feeding them
    times = []
    log = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(log):
        train.main(p2p_argv(work, "spc_cli", "--batch_size", str(BENCH_BATCH),
                            "--compute_dtype", "bfloat16", "--steps_per_call", str(SPC_K),
                            "--synthetic_samples", str(BENCH_BATCH * SPC_K * SPC_CALLS),
                            "--device", "cuda"), step_times=times)
    torch.cuda.synchronize()
    counts = read_counts()
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("(epoch:")]
    iters = [int(re.search(r"iters: (\d+)", ln).group(1)) for ln in lines]
    check(iters == [BENCH_BATCH * SPC_K * (c + 1) for c in range(SPC_CALLS)]
          and not any("nan" in ln or "inf" in ln for ln in lines),
          f"pix2pix --steps_per_call {SPC_K} CLI: loss lines {lines}")
    check(not any(counts.values()), f"pix2pix --steps_per_call CLI: launches {counts}")
    out["cli"] = {"call_s": times, "loss_lines": lines}
    print(f"  cli --steps_per_call {SPC_K}: {lines[-1]}; s/call {[round(t, 3) for t in times]} "
          f"(the batches from the synthetic loader, {cfg.num_threads} reader threads)")
    torch.cuda.empty_cache()

    # one K=2 call held to two single steps (bf16, dropout on)
    cfg = parse_config(p2p_argv(work, "spc_held", "--batch_size", str(SPC_HELD_BATCH),
                                "--compute_dtype", "bfloat16", "--steps_per_call", "2",
                                "--device", "cuda"), train=True)
    cfg.steps_per_epoch = 1000
    out["held_pix2pix"], f = spc_held(torch, "pix2pix bench configuration K=2 bf16", cfg,
                                      spc_stack(torch, 2, SPC_HELD_BATCH, seed=2), 2)
    fails += f
    check(not any(out["held_pix2pix"]["launches"].values()),
          f"pix2pix K=2 call: launches {out['held_pix2pix']['launches']}")

    # (b) CycleGAN on the all-kernel route, K=2: one call held to two single
    # steps with exact launches, then the CLI's three calls
    argv = train_argv("all", "bfloat16", work, "spc_cg", extra=["--steps_per_call", "2"])
    cfg = parse_config(argv, train=True)
    cfg.steps_per_epoch = TRAIN_SAMPLES
    batches = [train.batch_to(d, dev) for d in create_dataset(cfg)][:2]
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    per_step = with_path_counts(TRAIN_ROUTES["all"][1], "bfloat16", NORM_CALLS["all"])
    held, f = spc_held(torch, "CycleGAN all-kernel route K=2 bf16", cfg, stack, 2)
    fails += f
    counts = held.pop("launches")
    want = {k: 2 * per_step.get(k, 0) for k in counts}
    check(counts == want, f"CycleGAN all K=2 call: launches {counts}, expected {want}")
    out["held_cyclegan"] = {**held, "launches_per_call": {k: v for k, v in counts.items() if v}}
    log = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(log):
        train.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: TRAIN_SAMPLES * per_step.get(k, 0) for k in counts}
    check(counts == want, f"CycleGAN all --steps_per_call 2 CLI: launches {counts}, "
          f"expected {want}")
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("(epoch:")]
    check(len(lines) == TRAIN_SAMPLES // 2, f"CycleGAN --steps_per_call 2 CLI: {lines}")
    out["cyclegan_cli"] = {"launches": {k: v for k, v in counts.items() if v},
                           "loss_lines": lines}
    print(f"CycleGAN --fused_blocks --conv7_pallas 1 --force_pallas_norm bf16 "
          f"--steps_per_call 2: launches per call {out['held_cyclegan']['launches_per_call']}"
          f" (2 x phase 7's step); the CLI's {len(lines)} calls: {out['cyclegan_cli']['launches']}")
    del batches, stack
    torch.cuda.empty_cache()

    # (c) the bf16 first moment on the bench configuration: three steps
    # against the f32 moment's, from the same state, batches and draws
    stack = spc_stack(torch, MU_STEPS, BENCH_BATCH, seed=3)
    runs = {}
    for mu in ("float32", "bfloat16"):
        cfg = parse_config(p2p_argv(work, "mu", "--batch_size", str(BENCH_BATCH),
                                    "--compute_dtype", "bfloat16", "--no-in_graph_aug",
                                    "--adam_mu_dtype", mu, "--device", "cuda"), train=True)
        cfg.steps_per_epoch = 1000
        state = create_state(cfg, dev)
        step = make_train_step(cfg)
        ms = []
        for i in range(MU_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, _ = step(state, {k: v[i] for k, v in stack.items()},
                             step_generator(cfg.seed, i))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[mu] = {"ms": ms, "losses": {k: float(v) for k, v in losses.items()},
                    "dtypes": {str(t.dtype) for o in state.opts.values() for t in o.mu.values()},
                    "params": [p.detach().float().cpu() for net in state.nets.values()
                               for p in net.parameters()]}
        del state, step
        torch.cuda.empty_cache()
    bound = 2 * MU_STEPS * cfg.lr  # tests/unit/test_adam_mu_bf16.py's bound
    worst = max(float((a - b).abs().max()) for a, b in zip(runs["bfloat16"]["params"],
                                                          runs["float32"]["params"]))
    check(runs["bfloat16"]["dtypes"] == {"torch.bfloat16"},
          f"--adam_mu_dtype bfloat16: first moments in {runs['bfloat16']['dtypes']}")
    loss_ok = all(abs(runs["bfloat16"]["losses"][k] - v) <= 2e-2 * (1 + abs(v))
                  for k, v in runs["float32"]["losses"].items())
    if worst > bound or not loss_ok:
        fails.append(f"--adam_mu_dtype bfloat16: parameters {worst:.4g} from the f32 moment's "
                     f"(bound {bound:.4g}), losses {runs['bfloat16']['losses']} vs "
                     f"{runs['float32']['losses']}")
    out["adam_mu_bf16"] = {"max_param_diff": worst, "bound": bound,
                           **{f"{k}_ms": v["ms"] for k, v in runs.items()},
                           **{f"{k}_losses": v["losses"] for k, v in runs.items()}}
    print(f"--adam_mu_dtype bfloat16, bench configuration batch {BENCH_BATCH}, {MU_STEPS} "
          f"steps: every first moment bf16; parameters within {worst:.4g} of the f32 moment's "
          f"run (bound {bound:.4g}); step-{MU_STEPS} losses {runs['bfloat16']['losses']} vs "
          f"{runs['float32']['losses']}; ms/step f32 moment "
          f"{[round(m, 3) for m in runs['float32']['ms']]}, bf16 "
          f"{[round(m, 3) for m in runs['bfloat16']['ms']]} on {name}")
    del runs, stack
    torch.cuda.empty_cache()

    # (d) the threaded loader on phase 5's store: whole 721x1440 fields
    argv = ["--model", "pix2pix", "--dataset_mode", "climate", "--phase", "test",
            "--dataroot", os.path.join(work, "data"), "--full_field", "--batch_size", "1",
            "--input_nc", str(N_VARS), "--output_nc", str(N_VARS), "--device", "cuda"]
    read = {}
    for threads in (0, LOADER_THREADS):
        loader = create_dataset(parse_config(argv + ["--num_threads", str(threads)],
                                             train=True))
        t0 = time.perf_counter()
        batches = [b for _ in range(LOADER_EPOCHS) for b in loader]
        read[threads] = (batches, (time.perf_counter() - t0) * 1e3 / len(batches))
    same = len(read[0][0]) == len(read[LOADER_THREADS][0]) == LOADER_EPOCHS * N_TIMES and all(
        a.keys() == b.keys() and all(
            a[k] == b[k] if k.endswith("_paths") else np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(read[0][0], read[LOADER_THREADS][0]))
    check(same, "--num_threads 4: the batches differ from --num_threads 0's")
    out["loader"] = {"ms_per_batch": {str(t): v[1] for t, v in read.items()},
                     "batches": len(read[0][0])}
    print(f"loader on the NetCDF-3 store ({GLOBE_H}x{GLOBE_W}x{N_VARS} fields, A and B, "
          f"batch 1, {LOADER_EPOCHS} epochs): --num_threads 0 {read[0][1]:.3f} ms/batch, "
          f"--num_threads {LOADER_THREADS} {read[LOADER_THREADS][1]:.3f} ms/batch, batches "
          f"bitwise equal (a consumer that does nothing else; {os.cpu_count()} host cores)")
    del read

    # (e) K-step calls on the meshes: CycleGAN --fused_blocks, global batch 2
    want = {k: v * 4 for k, v in with_path_counts(CG_MESH_STEP, "bfloat16").items() if v}
    out["meshes"] = {}
    for what, flags in (("data", ["--data_mesh", "2"]), ("mesh", MESH_FLAGS)):
        argv = train_argv("fused", "bfloat16", work, f"spc_{what}", extra=flags + [
            "--batch_size", str(MESH_BATCH), "--synthetic_samples", str(MESH_BATCH * 4),
            "--steps_per_call", "2"])
        result, _ = mesh_cli(torch, argv, 2, f"CycleGAN {' '.join(flags)} --steps_per_call 2")
        for r, counts in enumerate(result["launches"]):
            counts = {k: v for k, v in counts.items() if v}
            check(counts == want, f"{what} --steps_per_call 2: rank {r} launches {counts}, "
                  f"expected {want}")
        out["meshes"][what] = {"call_ms": result["step_ms"],
                               "launches_per_rank": result["launches"]}
        print(f"CycleGAN --fused_blocks bf16 {' '.join(flags)} --steps_per_call 2, two calls "
              f"of global batch {MESH_BATCH}: every rank bitwise equal; K2 per rank "
              f"{[{k: c[k] for k in want} for c in result['launches']]}; rank 0 ms/call "
              f"{[round(m, 1) for m in result['step_ms']]}")
    check(not fails, "; ".join(fails))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 13 (K steps a call, bf16 Adam moment, threaded loader): "
          f"{out['seconds']:.1f} s")
    return out


def kernel_report(times, errs, grad_times, grad_errs, bwd_errs, norm_bwd_errs, launches,
                  trained, spatial_times, halo, loopback, sharded, parent, norm_paths,
                  p2p, dp, spc) -> list:
    """The kernels line: each kernel's launches on its main path, error,
    times and bound; the differentiable forms' backward times beside
    cuDNN's through autograd, and their launches on the bf16 training
    routes; the block conv's halo W mode on the sharded --fused_blocks
    path, and its differentiable form on the sharded --fused_blocks
    training route; the block conv's backward kernel on both training
    routes; the instance norm's backward kernel on the all-kernel training
    route; the halo exchange on the sharded --halo_rdma path, on the route
    the ranks' cards give, and its signalled route on the loopback ring;
    the block conv's differentiable form and its backward kernel on the
    pix2pix --fused_blocks route (``pix2pix_phase``); each kernel's
    launches per data rank on the CycleGAN --data_mesh 2 routes that run it
    (``data_parallel_phase``); each kernel's launches in the CycleGAN
    --steps_per_call 2 CLI run on the all-kernel route
    (``steps_per_call_phase``); with a parent tree,
    the best times there and here (compare_parent).
    Backward bounds are ``bwd_work``'s."""
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
        if name in PATH_COUNTERS:
            counted = (trained["launches"][f"{path}/bfloat16"] if unit == "step"
                       else launches[path])
            entry["wgmma_launches"] = counted[f"{name}.{PATH_COUNTERS[name]}"]
        if name == "instance_norm_act":
            entry["path_launches"] = {
                where: {p: counted[f"{name}.{p}_launches"] for p in NORM_PATHS}
                for where, counted in (("plain_norm", launches["plain_norm"]),
                                       ("all (training)", trained["launches"]["all/bfloat16"]))}
            entry["path_cases"] = norm_paths["cases"]
        against = {k: v for k, v in parent.get("kernels", {}).items()
                   if k.split()[0] == name}
        if against:
            entry["parent"] = against
        form = {"conv3x3_valid": "conv3x3_op", "conv7x7": "conv7x7",
                "instance_norm_act": "instance_norm_act"}.get(name)
        if name == "conv3x3_valid":
            entry.update(bwd_launches=trained["launches"][f"{path}/bfloat16"]["conv3x3_valid.bwd"],
                         **{k: v for k, v in t.items() if k.startswith("bwd_kernel_")},
                         max_grad_err=grad_errs[form],
                         bwd_ms=grad_times[form]["bwd_ms"],
                         bwd_bound_ms=grad_times[form]["bwd_bound_ms"],
                         bwd_bound_by=grad_times[form]["bwd_bound_by"],
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
                "bwd_bound_ms": g["bwd_bound_ms"], "bwd_bound_by": g["bwd_bound_by"],
                "max_grad_err": grad_errs[form], "per": train_per, "calls": g["calls"]})
            if name in PATH_COUNTERS:
                entry["train"]["wgmma_launches"] = trained["launches"]["all/bfloat16"][
                    f"{name}.{PATH_COUNTERS[name]}"]
        elif name == "conv3x3_fused":
            t = spatial_times[name]
            entry["halo"] = {
                "path": "spatial_rdma_fused", "w_mode": "halo",
                "launches": launches["spatial_rdma_fused"][name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "per": "field per rank: the halo-mode call's best time times its 18 calls",
                "calls": t["calls"]}
            g = grad_times["conv3x3_fused_t"]
            entry["train"] = {
                "name": "conv3x3_fused_t", "replaces": "biasgan_tpu/ops/pallas_conv.py:1091",
                "route": "fused", "launches": trained["launches"]["fused/bfloat16"][
                    "conv3x3_fused_t"], "max_grad_err": grad_errs["conv3x3_fused_t"],
                "ms": g["ms"], "bwd_ms": g["bwd_ms"], "plain_ms": g["plain_ms"],
                "library_ms": g["library_ms"], "library_bwd_ms": g["library_bwd_ms"],
                "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                "bwd_bound_ms": g["bwd_bound_ms"], "bwd_bound_by": g["bwd_bound_by"],
                "per": train_per, "calls": g["calls"]}
            g = grad_times["conv3x3_fused_t_halo"]
            entry["train"]["halo"] = {
                "route": "spatial_fused", "w_mode": "halo",
                "launches": sharded["launches"]["spatial_fused"]["conv3x3_fused_t"],
                "max_grad_err": grad_errs["conv3x3_fused_t_halo"],
                "ms": g["ms"], "bwd_ms": g["bwd_ms"], "plain_ms": g["plain_ms"],
                "library_ms": g["library_ms"], "library_bwd_ms": g["library_bwd_ms"],
                "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                "bwd_bound_ms": g["bwd_bound_ms"], "bwd_bound_by": g["bwd_bound_by"],
                "per": (f"step per rank of --spatial_mesh {N_RANKS}: each call's best time "
                        f"times its count; launches per rank in the {SHARDED_CLI_STEPS}-step "
                        "CLI run"),
                "calls": g["calls"]}
            entry["train"]["pix2pix"] = {
                "route": " ".join(["--model pix2pix"] + P2P_ROUTE),
                "launches": p2p["route"]["launches"]["conv3x3_fused_t"],
                "per": f"the {P2P_ROUTE_STEPS}-step bf16 CLI run, 256x256 batch 1"}
        kernels.append(entry)
    bwd = {}
    for form, route, n in (("conv3x3_fused_t", "fused", trained["launches"]["fused/bfloat16"]),
                           ("conv3x3_fused_t_halo", "spatial_fused",
                            sharded["launches"]["spatial_fused"])):
        g = grad_times[form]
        bwd[form] = {
            "route": route, "launches": n["conv3x3_fused_bwd"],
            "wgmma_launches": n["conv3x3_fused_bwd.wgmma_launches"], "ms": g["kernel_bwd_ms"],
            "plain_ms": g["plain_bwd_ms"], "bound_ms": g["bwd_bound_ms"],
            "bound_by": g["bwd_bound_by"], "library_ms": g["library_bwd_ms"],
            "autograd_ms": g["bwd_ms"],
            "device_kernels_per_bwd": g["calls"][0]["device_kernels_per_bwd"],
            "calls": [{k: c[k] for k in ("shape", "options", "count", "kernel_bwd_ms",
                                         "plain_bwd_ms", "library_bwd_ms", "bwd_ms",
                                         "bwd_bound_ms")} for c in g["calls"]]}
    kernels.insert(1, {
        "name": "conv3x3_fused_bwd", "route": "cuda",
        "source": "biasgan_tpu_torch/kernels/csrc/conv3x3_fused_bwd.cu",
        "replaces": "biasgan_tpu/ops/pallas_conv.py:972",
        **{k: v for k, v in bwd["conv3x3_fused_t"].items() if k != "route"},
        "max_abs_err": bwd_errs["max_abs_err"], "max_grad_err": bwd_errs["max_grad_err"],
        "path": "fused (training)",
        "kernels": ("bf16: prep_kernel (dYc, u_pad, the packed weight); the input "
                    "gradient on conv_tma_kernel (csrc/conv3x3_tma.cuh: TMA, wgmma, the "
                    "reflect folds, the DGRAD epilogue); wgrad_tma_kernel (a wgmma GEMM "
                    "over the pixels, split-K); reduce_kernel"),
        "device_ms_by_kernel": grad_times["conv3x3_fused_t"].get(
            "kernel_bwd_device_ms_per_step_by_kernel"),
        "per": ("step: each training-shape call's best time times its count per 256x256 "
                "CycleGAN step at batch 1, bf16; ms the kernel called directly, plain_ms the "
                "torch-ops backward (cuDNN dgrad and wgrad), library_ms cuDNN's conv backward "
                "through autograd, autograd_ms the kernel through conv3x3_fused_t's autograd; "
                "launches in the six-step bf16 CLI run"),
        "halo": bwd["conv3x3_fused_t_halo"],
        "pix2pix_launches": p2p["route"]["launches"]["conv3x3_fused_bwd"],
    })
    g = grad_times["instance_norm_act"]
    norm = next(i for i, k in enumerate(kernels) if k["name"] == "instance_norm_act")
    kernels.insert(norm + 1, {
        "name": "instance_norm_act_bwd", "route": "cuda",
        "source": "biasgan_tpu_torch/kernels/csrc/instance_norm_act_bwd.cu",
        "replaces": "biasgan_tpu/ops/pallas_fused.py:188",
        "launches": trained["launches"]["all/bfloat16"]["instance_norm_act_bwd"],
        "max_abs_err": norm_bwd_errs["max_abs_err"],
        "max_grad_err": norm_bwd_errs["max_grad_err"],
        "ms": g["kernel_bwd_ms"], "plain_ms": g["plain_bwd_ms"], "bound_ms": g["bwd_bound_ms"],
        "bound_by": g["bwd_bound_by"], "library_ms": g["library_bwd_ms"],
        "autograd_ms": g["bwd_ms"], "path": "all (training)",
        "per": ("step: each training-shape call's best time times its count per 256x256 "
                "CycleGAN step at batch 1, bf16; ms the kernel called directly, plain_ms the "
                "torch-ops backward, library_ms F.instance_norm + act's backward through "
                "autograd, autograd_ms the kernel through instance_norm_act's autograd; "
                "launches in the six-step bf16 CLI run"),
        "device_kernels_per_bwd": g["calls"][0]["device_kernels_per_bwd"],
        "device_ms_per_step": g["device_ms_per_step"],
        "calls": [{k: c[k] for k in ("shape", "options", "count", "kernel_bwd_ms",
                                     "plain_bwd_ms", "library_bwd_ms", "bwd_ms", "bwd_bound_ms",
                                     "device_kernels_per_bwd", "device_ms_per_bwd")}
                  for c in g["calls"]],
    })
    h = halo["totals"]["spatial_rdma"]
    entry = {
        "name": "halo_exchange_w", "route": "cuda",
        "source": "biasgan_tpu_torch/kernels/csrc/halo_exchange.cu",
        "replaces": "biasgan_tpu/ops/pallas_halo.py:96",
        "launches": launches["spatial_rdma"]["halo_exchange_w"],
        "max_abs_err": halo["max_abs_err"],
        "ms": h["kernel_ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
        "bound_by": "bytes", "library_ms": h["library_ms"], "path": "spatial_rdma",
        "halo_route": halo["route"],
        "per": (f"field per rank of {N_RANKS} ranks, "
                f"{'each on its own card' if halo['route'] == 'signalled' else 'all on one card'}"
                ": each exchange shape's best time times its exchanges per forward; ms is, on "
                "the host route, "
                "the copy kernel alone (CUDA events), on the signalled route the device time "
                "of the send and receive kernels (torch.profiler); exchange_ms the whole "
                "exchange back to back (host clock: on the host route with its stream sync, "
                "barrier and read); plain_ms the plain ring (host copies under gloo), "
                "library_ms its messages alone (batch_isend_irecv, on host tensors under "
                "gloo); launches are exchanges"),
        "exchange_ms": h["exchange_ms"], "nvlink_bound_ms": h["nvlink_bound_ms"],
        "backend": halo["backend"], "calls": h["calls"],
        "fused": {k: v for k, v in halo["totals"]["spatial_rdma_fused"].items()
                  if k != "calls"},
        "signalled": {
            "where": f"loopback: a ring of {N_RANKS} peers in one process on one card",
            "device_ms_per_forward": loopback["spatial_rdma"]["device_ms"],
            "event_ms_per_forward": loopback["spatial_rdma"]["event_ms"],
            "device_ms_per_exchange": {f"{tuple(c['shape'])} {c['dtype']}": c["device_ms"]
                                       for c in loopback["spatial_rdma"]["calls"]},
            "fused": {k: v for k, v in loopback["spatial_rdma_fused"].items() if k != "calls"},
        },
    }
    if parent.get("sharded"):
        entry["parent"] = parent["sharded"]
    kernels.append(entry)
    for route, names in DP_CG_ROUTES.items():
        run = dp["cyclegan"][route]
        for k in kernels:
            if k["name"] in names:
                k["data_parallel"] = {
                    "route": " ".join(["--model cycle_gan"] + run["flags"][:-2]),
                    "launches_per_rank": [c[k["name"]] for c in run["launches"]],
                    "per": (f"each rank of the {DP_CG_STEPS}-step bf16 CLI run, 256x256, "
                            f"global batch {DP_RANKS}"),
                    **{f"{attr}_per_rank": [c[f"{k['name']}.{attr}"] for c in run["launches"]]
                       for attr in ("wgmma_launches", "cluster_launches", "persistent_launches")
                       if f"{k['name']}.{attr}" in run["launches"][0]}}
    cli = spc["cyclegan_cli"]["launches"]
    for k in kernels:
        names = [n for n in (k["name"], "conv3x3_fused_t" if k["name"] == "conv3x3_fused"
                             else None) if n in cli]
        if names:
            k["steps_per_call"] = {
                "route": "--model cycle_gan " + " ".join(TRAIN_ROUTES["all"][0])
                         + " --steps_per_call 2",
                "launches": {n: cli[n] for n in names},
                "per": (f"the bf16 CLI run, 256x256 batch 1: {TRAIN_SAMPLES // 2} calls of 2 "
                        "steps")}
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
    # a check build: a kernel's spin wait (an mbarrier's phase, the halo
    # exchange's flags) that never ends traps (and fails the phase) instead
    # of holding the card
    os.environ["BIASGAN_KERNEL_WATCHDOG"] = "1"
    work = os.path.join(HERE, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        environment(torch)
        build_kernels()
        errs = check_kernels(torch)
        norm_paths = check_norm_paths(torch)
        times = time_kernels(torch)
        spatial_times = time_kernels(torch, SPATIAL_CALLS)
        halo = check_halo_exchange(torch)
        loopback = check_halo_loopback(torch)
        bwd_errs = check_bwd_kernel(torch)
        norm_bwd_errs = check_norm_bwd_kernel(torch)
        grad_errs = check_grads(torch)
        grad_times = in_fresh_process("time_grads", work)
        check_small_generator(torch)
        check_small_sharded(torch)
        launches = serve_globe(torch, work)
        parent = compare_parent(torch, work)
        trained = train_phase(torch, work)
        sharded = sharded_train_phase(torch, work)
        p2p = pix2pix_phase(torch, work)
        dp = data_parallel_phase(torch, work)
        mesh = mesh_phase(torch, work)
        tested = test_driver_phase(torch, work)
        spc = steps_per_call_phase(torch, work, p2p["bench"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"training": {**trained, "pix2pix": p2p}, "sharded_training": sharded,
                      "data_parallel": dp, "mesh": mesh, "test_driver": tested,
                      "steps_per_call": spc}))
    print(json.dumps({"kernels": kernel_report(times, errs, grad_times, grad_errs, bwd_errs,
                                               norm_bwd_errs, launches, trained,
                                               spatial_times, halo, loopback, sharded,
                                               parent, norm_paths, p2p, dp, spc)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
