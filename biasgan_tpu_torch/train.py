"""Training CLI: the reference's train.py loop on one device, on N data
ranks, or on N W shards.

  python -m biasgan_tpu_torch.train --model cycle_gan --dataset_mode synthetic \\
      --netG resnet_9blocks --ngf 64 --ndf 64 --crop_size 256 --input_nc 3 \\
      --output_nc 3 --batch_size 1 --compute_dtype bfloat16 --fused_blocks \\
      --name RUN --device cuda
  python -m biasgan_tpu_torch.train --model pix2pix --dataset_mode synthetic \\
      --compute_dtype bfloat16 --name RUN --device cuda
  python -m biasgan_tpu_torch.train --model pix2pix --dataset_mode synthetic \\
      --compute_dtype bfloat16 --batch_size 128 --data_mesh 2 --val_split 128 \\
      --val_freq 256 --name RUN --device cuda

(pix2pix at the reference's defaults: unet_256 G, basic D, batch norm,
vanilla GAN + L1, dropout on, 256x256.)

Counterpart of the repo-root ``train.py`` (:59-249), with its flags:
parse the config, build the dataset and the training state, then the epoch
loop (fetch a batch, move it to the device, one optimization step; the
validation metrics, print and log the losses, save at the cadences;
advance the LR schedule at each epoch's end). The loss line is the
reference's, ``(epoch: E, iters: I, time: T, data: D) G_GAN: ... D_fake:
...`` (CycleGAN: ``D_A: ... idt_B: ...``), to stdout and
``<run_dir>/loss_log.txt``. Saves write the full training state
(``ckpt/<tag>.pt``) and each net's ``<tag>_net_<name>.pth``, which
``python -m biasgan_tpu_torch.infer`` loads; ``--continue_train`` resumes
from the state at ``--epoch`` (with ``--epoch_count`` the next epoch).

Validation (the repo-root train.py's, :32-57, :166-245): --val_split N holds the
last N samples out ("The number of validation images = N"), else a 'val'
phase directory of climate or image data serves. Every --val_freq
samples (global) the loop prints ``validation (train batch): rmse: ...
bias: ... pdf_tv: ... log_spectral_distance: ...`` of the step's visuals,
then ``validation (held out): ...``, the mean over at most 4 held-out
batches of an eval-mode forward (``models.base``). Under --lr_policy
plateau the tracked metric is the held-out RMSE over every held-out batch,
else (no held-out data) that of an eval forward on the last training
batch; the warning line prints only where neither exists.

The kernel routes are the JAX CLI's flags: --fused_blocks (the block convs
through conv3x3_fused_t: the fused kernel with its exact backward),
--pallas_conv 1 (the block convs and their input gradients through
conv3x3_valid), --conv7_pallas 1 (the 7x7 stem and head through conv7x7)
and --force_pallas_norm (the instance norms of G and D through
instance_norm_act). Each prints whether it engaged, or why not.

--data_mesh N (N > 1) trains data-parallel (the JAX CLI's
``data_parallel_step``): N spawned ranks (``parallel.mesh``), each building
the same state from --seed and stepping on its contiguous slice of every
global batch of --batch_size (which must split evenly), with its own
dropout and augmentation draws; the grads, losses and batch-norm running
averages are averaged over the ranks (``parallel.DataCtx``), so every
rank's parameters stay bitwise equal. The kernel routes engage on every
rank as on one device. Ranks sharing a card (one card, N ranks) talk over
gloo through host copies; a card per rank, over NCCL: the startup line
says which.

--spatial_mesh N (N > 1) trains spatially sharded (the JAX CLI's
``models/base.py:55-100``): N spawned ranks, one process per W shard,
each building the same state from --seed and reading the same global
batches; each rank runs the step on its W shard (``make_train_step(...,
ctx=...)`` of pix2pix or CycleGAN: batch norm with W-global moments, the
dropout masks drawn whole-W), and the losses, the grads and so the updated
parameters are the one-device step's. Sharding needs a W pad that does not
reflect (--w_pad_mode wrap or zero; a U-Net pads zero unless told) and a
crop whose W splits over N x 2^downs; pix2pix refuses wgangp with the
pixel D, as the JAX step does; --halo_rdma is ignored, with a notice (the
kernel has no backward, and the JAX training context has no rdma);
--fused_blocks takes the block conv's halo W mode.

--data_mesh D with --spatial_mesh S (both > 1) trains on the 2-D mesh of
D x S ranks (JAX ``make_mesh(D, S)``, axes ("data", "spatial")): world
rank r is (d, s) = divmod(r, S) (``parallel.mesh.mesh_groups``); each row
of S ranks steps on data slice d of every global batch, sharded on W, as
--spatial_mesh S does; the grads, the losses and the running averages are
averaged over every rank, the batch statistics stay the row's, and
CycleGAN's pools gather their fakes over the data column.

Under any of them, rank 0 prints the loss lines and writes
``loss_log.txt`` and the checkpoints (the pools gathered on W where they
are sharded), a rank that fails fails the run, and the parent prints each
rank's kernel launches, its peak memory (and, with data ranks, its host
ms in the grads' all-reduce), and ``<data|spatial|mesh>: parameters
bitwise equal on every rank: True`` (the running averages included; False
raises).

Observability (the repo-root train.py's, :62-68, :139-164, :204-207):
``utils.visualizer.Visualizer`` writes the loss lines and, every
--display_freq samples (global), the HTML snapshot page of the step's
visuals (``<run_dir>/web/index.html``, rank 0; the whole W gathered under
a spatial context), its rows kept across a resume. --check_finite N
raises FloatingPointError naming the non-finite losses every N steps of
the run, and every 10 N steps also sweeps every net's parameters and
running averages. --debug_nans runs the loop in autograd's anomaly mode
(``torch.autograd.set_detect_anomaly``, the counterpart of
``jax_debug_nans``): a backward op that returns NaN raises, naming the
forward op that made it. --profile writes a ``torch.profiler`` Chrome
trace of the run's steps 10-20, with the port's spans on (``trace``), to
``<run_dir>/profile/trace.json`` (a rank's to ``trace_rank<r>.json``) and
prints its path.

--steps_per_call K (the JAX CLI's scan of K steps per dispatch,
``models.common.make_scan_step``): the loop groups the loader's batches K
at a time (an epoch's ragged tail of fewer than K is dropped), copies each
(K, B, ...) stack to the device once, and runs the step K times with no
host read between; step i draws from ``step_generator(--seed, its global
step)``, so a K-step run is the run of K single steps. ``total_iters``
advances by --batch_size x K, the cadences fire on K-step chunks (``<
batch_size * K``), the loss line and --check_finite read the call's last
step, and --check_finite and --profile count calls, as the JAX CLI counts
dispatches. Under --data_mesh each rank stacks its own slices; under
--spatial_mesh every rank stacks the global batches and each step shards
its own. The checkpoint's ``host_step`` counts steps.

--num_threads N reads the batches on a producer thread over N workers,
two batches ahead (``data.DataLoader``); the batches are those of 0.

Not carried: the JAX visualizer's TensorBoard writer (it engages only
where tensorboardX imports; the GPU host has no such package).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from biasgan_tpu_torch import trace
from biasgan_tpu_torch.config import (
    format_config,
    mesh_of,
    parse_config,
    route_on,
    save_config,
)
from biasgan_tpu_torch.data import create_dataset
from biasgan_tpu_torch.infer import pallas_conv_notices
from biasgan_tpu_torch.models.base import (
    Plateau,
    average_metrics,
    evaluate_metrics_on,
    plateau_update,
    validation_metrics_of,
)
from biasgan_tpu_torch.models.common import make_lr_schedule, make_scan_step, stack_batches
from biasgan_tpu_torch.nn.generators import fused_blocks_blocker
from biasgan_tpu_torch.nn.layers import conv7_eligible
from biasgan_tpu_torch.nn.factory import unet_downs
from biasgan_tpu_torch.parallel import DataCtx, HaloCtx, placement, spawn
from biasgan_tpu_torch.parallel.checks import kernel_counts
from biasgan_tpu_torch.parallel.mesh import RankCtx, mesh_groups
from biasgan_tpu_torch.registry import get_model
from biasgan_tpu_torch.utils import checkpoint, diagnostics
from biasgan_tpu_torch.utils.visualizer import Visualizer


def routing_notices(cfg, state) -> list:
    """One line per kernel flag: engaged, or ignored and why."""
    notes = []
    resnet = cfg.netG.startswith("resnet")
    gens = [k for k in state.nets if k.startswith("G")]
    blocker = (fused_blocks_blocker(cfg.norm, cfg.dropout()) if resnet
               else f"netG {cfg.netG!r} has no resnet block chain")
    fused = cfg.fused_blocks and blocker is None
    if cfg.fused_blocks:
        notes.append(
            "--fused_blocks: fused training path engaged (conv3x3_fused_t on the "
            "block convs)" if fused else f"--fused_blocks: ignored — {blocker}; "
            "using the plain path"
        )
    if cfg.fused_updown:
        notes.append("--fused_updown: ignored — the fused down/up kernels are "
                     "inference-only (no backward, as in JAX)")
    if route_on("--pallas_conv", cfg.pallas_conv):
        notes += pallas_conv_notices(cfg, blocker if resnet else None) or [
            "--pallas_conv: engaged (conv3x3_op on the block convs, forward and input "
            "gradient)"]
    if route_on("--conv7_pallas", cfg.conv7_pallas):
        if not resnet:
            notes.append(f"--conv7_pallas: ignored — netG {cfg.netG!r} has no 7x7 conv")
        for g in gens if resnet else ():
            for conv in ("stem", "head"):
                mod = getattr(state.nets[g], conv)
                if not conv7_eligible(mod.weight.shape, mod.stride, mod.padding):
                    notes.append(f"--conv7_pallas: the {g} {conv} stays on cuDNN — the "
                                 "kernel takes a 7x7 conv with exactly one channel "
                                 "side of at most 8")
        if not any(n.startswith("--conv7_pallas") for n in notes):
            notes.append("--conv7_pallas: engaged (conv7x7 on the stems and heads)")
    if cfg.force_pallas_norm:
        if cfg.norm != "instance":
            notes.append(f"--force_pallas_norm: ignored — norm {cfg.norm!r} is not "
                         "instance norm")
        elif resnet:
            notes.append("--force_pallas_norm: engaged (instance_norm_act on the instance "
                         "norms of G and D)")
        else:
            notes.append("--force_pallas_norm: engaged on the D's instance norms only — "
                         f"netG {cfg.netG!r} normalizes without it, as the JAX U-Net")
    return notes


def spatial_notices(cfg) -> list:
    """The lines of a sharded run (--spatial_mesh N > 1) for the flags that
    engage otherwise there: the kernel routes that cannot engage on a
    sharded W (the JAX gates turn them off under a context), and
    --halo_rdma."""
    why = "it cannot engage on a sharded W"
    notes = []
    if cfg.fused_blocks:
        blocker = fused_blocks_blocker(cfg.norm, cfg.dropout())
        notes.append(
            "--fused_blocks: fused training path engaged (conv3x3_fused_t in its halo W "
            "mode on the block convs)" if blocker is None else
            f"--fused_blocks: ignored — {blocker}; using the plain path")
    if cfg.fused_updown:
        notes.append("--fused_updown: ignored — the fused down/up kernels are "
                     "inference-only (no backward, as in JAX)")
    if route_on("--pallas_conv", cfg.pallas_conv):
        notes.append(f"--pallas_conv: ignored — {why}")
    if route_on("--conv7_pallas", cfg.conv7_pallas):
        notes.append(f"--conv7_pallas: ignored — {why}; the stems and heads stay on cuDNN")
    if cfg.force_pallas_norm and cfg.norm == "instance":
        notes.append("--force_pallas_norm: engaged on the Ds' norms only (they see the "
                     f"gathered W); ignored on the Gs' — {why}")
    if cfg.halo_rdma:
        notes.append("--halo_rdma: ignored in training — the halo_exchange_w kernel has no "
                     "backward; the halos take the plain ring (the JAX training context has "
                     "no rdma either)")
    return notes


def batch_to(data, device):
    """The batch's arrays as tensors on ``device`` (paths stay behind)."""
    return {
        k: torch.as_tensor(v).to(device, non_blocking=True)
        for k, v in data.items() if not k.endswith("_paths")
    }


def sharded_w_mode(cfg) -> str:
    """The generator's W pad mode as --w_pad_mode resolves it (the resnets
    reflect by default, the U-Nets pad zero); raises where it reflects,
    which cannot shard."""
    w_mode = cfg.w_pad_mode or ("zero" if unet_downs(cfg.netG) is not None else "reflect")
    if w_mode == "reflect":
        raise ValueError(
            f"--spatial_mesh {cfg.spatial_mesh} shards the width axis, which cannot be "
            f"reflect-padded: --w_pad_mode {cfg.w_pad_mode or '(unset: reflect)'}; pass "
            "--w_pad_mode wrap (periodic longitude) or --w_pad_mode zero"
        )
    return w_mode




def build_val_loader(cfg, rank: int = 0, ranks: int = 1):
    """The held-out loader (the repo-root train.py's ``_build_val_loader``):
    --val_split N's last N samples, else a 'val' phase directory of
    climate or image data (climate and unaligned: valA/ and valB/, aligned:
    val/, single: --dataroot itself); None where neither exists. ``rank`` of ``ranks``: a
    data-parallel rank's slices."""
    if cfg.val_split > 0:
        return create_dataset(cfg, "val", rank, ranks)
    if cfg.dataset_mode in ("climate", "aligned", "unaligned", "single"):
        try:
            return create_dataset(dataclasses.replace(cfg, phase="val"), None, rank, ranks)
        except FileNotFoundError:
            return None
    return None


def format_metrics(metrics) -> str:
    return " ".join(f"{k}: {v:.4f}" for k, v in metrics.items())


def display(visualizer, visuals, epoch: int, ctx=None) -> None:
    """The step's visuals on the HTML snapshot page (rank 0 writes): the
    whole W gathered under a spatial context (collective), the first
    sample of the global batch under data ranks (rank 0's first)."""
    shown = {k: v for k, v in visuals.items() if not k.startswith("_")}
    if ctx is not None:
        shown = {k: ctx.gather_w(v.detach()) for k, v in shown.items()}
    if visualizer is not None:
        visualizer.display_current_results(shown, epoch)


def check_finite(state, losses, where: str, params: bool = False) -> None:
    """--check_finite: raise FloatingPointError naming the non-finite
    losses, and with ``params`` the nets holding a non-finite parameter or
    running average (the JAX model's ``check_finite``)."""
    diagnostics.check_losses_finite({k: float(v) for k, v in losses.items()}, where)
    if params:
        for name, net in state.nets.items():
            diagnostics.assert_finite({f"net{name}.params": net}, where)


@contextlib.contextmanager
def debug_anomaly(cfg, say=print):
    """--debug_nans: autograd's anomaly mode for the run
    (``torch.autograd.set_detect_anomaly(True)``), PyTorch's counterpart of
    ``jax_debug_nans``: a backward op that returns NaN raises, naming the
    forward op that made it. Orders slower; the mode is restored after."""
    if not cfg.debug_nans:
        yield
        return
    say("--debug_nans: torch.autograd.set_detect_anomaly(True) for the run (a NaN from a "
        "backward op raises, naming its forward op; much slower)")
    with torch.autograd.set_detect_anomaly(True):
        yield


class StepProfiler:
    """--profile: a ``torch.profiler`` trace of this run's calls 10-20
    (steps 10-20 at --steps_per_call 1; the JAX CLI's window, which counts
    dispatches: after the first calls' warm-up), written as
    a Chrome trace to ``<run_dir>/profile/trace.json`` (a rank's to
    ``trace_rank<r>.json``); the path is printed. The port's spans
    (``trace``) are on in the window, so the trace names the step's
    phases, the generators' stages, the pads and each kernel launch."""

    START, STOP = 10, 20

    def __init__(self, cfg, device: torch.device, say=print, rank: Optional[int] = None):
        self.on = cfg.profile
        self.device, self.say = device, say
        name = "trace.json" if rank is None else f"trace_rank{rank}.json"
        self.path = os.path.join(cfg.run_dir(), "profile", name)
        self.prof = self.window = None

    def before_call(self, calls: int) -> None:
        if self.on and calls == self.START and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.window = contextlib.ExitStack()
            self.prof = self.window.enter_context(profile(activities=acts))
            self.window.enter_context(trace.enabled())

    def after_call(self, calls: int) -> None:
        if self.prof is not None and calls >= self.STOP:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.window.close()
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self.prof.export_chrome_trace(self.path)
            self.prof, self.on = None, False
            self.say(f"profile trace written to {self.path}")


def batch_stream(dataset, k: int):
    """The loader's batches as (k, B, ...) stacks (numpy; a batch of
    ``k`` = 1 is a view, no copy), k at a time; an epoch's ragged tail of
    fewer than k batches is dropped, as the JAX CLI drops it (its
    ``batch_stream``, train.py:110-130)."""
    group = []
    for b in dataset:
        if k == 1:
            yield {name: v[None] for name, v in b.items() if not name.endswith("_paths")}
            continue
        group.append(b)
        if len(group) == k:
            yield stack_batches(group)
            group = []


def train_loop(cfg, device: torch.device, say=print, ctx=None, dataset=None, data=None,
               step_times=None):
    """The reference's epoch loop on ``device`` (module docstring) over
    ``dataset`` (made from ``cfg`` unless given): state, resume, the calls
    of --steps_per_call steps, the validation metrics, the loss lines, the
    saves, the plateau policy. Under a spatial context ``ctx`` or a data
    context ``data`` this is one rank of a sharded or data-parallel run:
    every rank steps, only rank 0's ``say`` prints, and only rank 0 writes.
    ``step_times``: a list that takes each call's seconds (one step's at
    --steps_per_call 1), the stack's copy to the device included, the
    device synchronized after the call (before any validation). Returns the
    state."""
    model = get_model(cfg.model)
    rank, ranks = (0, 1) if data is None else (data.rank, data.size)
    writes = all(c is None or c.rank == 0 for c in (ctx, data))
    if dataset is None:
        dataset = create_dataset(cfg, "train" if cfg.val_split > 0 else None, rank, ranks)
    cfg.steps_per_epoch = len(dataset)
    say(f"The number of training images = {dataset.num_samples}")
    val_loader = build_val_loader(cfg, rank, ranks)
    if val_loader is not None:
        say(f"The number of validation images = {val_loader.num_samples}")

    state = model.create_state(cfg, device, ctx=ctx)
    run_dir = cfg.run_dir()
    host_step = 0
    if cfg.continue_train:
        tag = f"iter_{cfg.load_iter}" if cfg.load_iter > 0 else cfg.epoch
        meta = checkpoint.load_state(run_dir, tag, state, ctx)
        host_step = int(meta.get("host_step", state.step))
        say(f"resumed training state {tag!r} at step {state.step}")
    if ctx is None:
        for note in routing_notices(cfg, state):
            say(note)
    spc = max(cfg.steps_per_call, 1)
    call = make_scan_step(model.make_train_step(cfg, ctx=ctx, data=data), spc, cfg.seed)
    chunk = cfg.batch_size * spc  # the samples (global) of one call
    eval_fn = model.make_eval_fn(cfg)
    lr_fn = make_lr_schedule(cfg)
    plateau = Plateau()

    def held_out(limit=None):
        return average_metrics(
            evaluate_metrics_on(state, eval_fn, batch_to(vb, device), cfg, ctx, data)
            for vb in itertools.islice(val_loader, limit))

    def save(tag, meta):
        # a data-parallel run's state is the same on every data rank: data
        # rank 0 saves it alone; a sharded run (its row, on the 2-D mesh)
        # gathers its pools from every rank of the row
        if data is None or data.rank == 0:
            checkpoint.save_state(run_dir, tag, state, meta, ctx)

    visualizer = Visualizer(cfg, say) if writes else None
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    profiler = StepProfiler(cfg, device, say, None if ctx is None and data is None else
                            dist.get_rank())
    # this run's calls (the --check_finite and --profile counts: the JAX
    # CLI counts dispatches)
    calls = 0

    with debug_anomaly(cfg, say):
        total_iters = host_step * cfg.batch_size
        n_total = cfg.n_epochs + cfg.n_epochs_decay
        for epoch in range(cfg.epoch_count, n_total + 1):
            epoch_start = time.time()
            dataset.epoch = epoch - 1  # the shuffle order of this epoch
            last_batch = None
            t_data_mark = time.time()
            for stack in batch_stream(dataset, spc):
                t_data = time.time() - t_data_mark
                iter_start = time.time()
                total_iters += chunk
                stack = batch_to(stack, device)  # one copy of the call's k batches
                calls += 1
                profiler.before_call(calls)
                losses_k, visuals = call(state, stack, host_step)
                host_step += spc
                # the loss line, --check_finite, the metrics and the plateau
                # read the call's last step (JAX get_current_losses, test())
                losses = {k: v[-1] for k, v in losses_k.items()}
                last_batch = {k: v[-1] for k, v in stack.items()}
                if step_times is not None:
                    sync()
                    step_times.append(time.time() - iter_start)
                if cfg.check_finite and calls % cfg.check_finite == 0:
                    # raises FloatingPointError naming the loss (or net) at fault
                    check_finite(state, losses, f"epoch {epoch}, iters {total_iters}",
                                 params=calls % (10 * cfg.check_finite) == 0)
                profiler.after_call(calls)
                if cfg.val_freq and total_iters % cfg.val_freq < chunk:
                    metrics = validation_metrics_of(visuals, cfg, ctx, data)
                    if metrics:
                        say(f"validation (train batch): {format_metrics(metrics)}")
                    if val_loader is not None:
                        metrics = held_out(4)
                        if metrics:
                            say(f"validation (held out): {format_metrics(metrics)}")
                if total_iters % cfg.print_freq < chunk:
                    values = {k: float(v) for k, v in losses.items()}  # syncs the device
                    sync()
                    t_comp = (time.time() - iter_start) / chunk
                    if visualizer is not None:
                        visualizer.print_current_losses(epoch, total_iters, values, t_comp,
                                                        t_data)
                if total_iters % cfg.display_freq < chunk:
                    display(visualizer, visuals, epoch, ctx)
                del visuals, stack
                if total_iters % cfg.save_latest_freq < chunk:
                    say(f"saving latest (epoch {epoch}, total_iters {total_iters})")
                    save(f"iter_{total_iters}" if cfg.save_by_iter else "latest",
                         {"host_step": host_step, "epoch": epoch})
                t_data_mark = time.time()
            if epoch % cfg.save_epoch_freq == 0:
                say(f"saving model at end of epoch {epoch}, iters {total_iters}")
                meta = {"host_step": host_step, "epoch": epoch}
                save("latest", meta)
                save(f"epoch_{epoch}", meta)
            if cfg.lr_policy == "plateau":
                # the tracked metric: the held-out RMSE (eval mode) over every
                # held-out batch, else an eval forward on the last training batch
                if val_loader is not None:
                    metric = held_out().get("rmse")
                elif last_batch is not None:
                    metric = evaluate_metrics_on(state, eval_fn, last_batch, cfg, ctx,
                                                 data).get("rmse")
                else:
                    metric = None
                if metric is None:
                    say("warning: plateau policy found no rmse metric; lr will not decay "
                        "this epoch")
                plateau_update(state, plateau, metric)
            lr = lr_fn(state.step, state.lr_scale)
            say(f"End of epoch {epoch} / {n_total} \t Time: {time.time() - epoch_start:.1f}s"
                f" \t lr: {lr:.3e}")
    return state


def params_equal_across_ranks(state, ctx, pools=None) -> bool:
    """Whether every net's parameters and running averages on every rank
    of ``ctx`` equal its rank 0's, bitwise, and with ``pools`` (a context)
    the replay pools on every rank of ``pools`` (collective)."""
    parts = [t.detach().float().reshape(-1) for net in state.nets.values()
             for t in (*net.parameters(), *net.buffers()) if t.is_floating_point()]
    same = ctx.same_on_every_rank(torch.cat(parts))
    if pools is not None and state.pools:
        bufs = torch.cat([p.buffer.reshape(-1) for p in state.pools.values()])
        same = pools.same_on_every_rank(bufs) and same
    return same


def rank_contexts(cfg, n: int) -> tuple:
    """(spatial context, data context) of this rank of an ``n``-rank run
    (``mesh_of``): a HaloCtx over the W shards, a DataCtx over the data
    ranks, or on the 2-D mesh both, over the rank's row and column; None
    for an axis of one rank."""
    data_n, spatial_n = mesh_of(cfg)
    if data_n > 1 and spatial_n > 1:
        data_group, spatial_group = mesh_groups(data_n, spatial_n)
        return (HaloCtx(spatial_n, periodic=sharded_w_mode(cfg) == "wrap",
                        group=spatial_group),
                DataCtx(data_n, data_group, spatial=spatial_n))
    if data_n > 1:
        return None, DataCtx(n)
    return HaloCtx(n, periodic=sharded_w_mode(cfg) == "wrap"), None


def train_rank(rank, n, device, say, argv):
    """One rank of a data-parallel (--data_mesh), sharded (--spatial_mesh)
    or 2-D mesh run (``parallel.spawn``): the command line's config, its
    slice or W shard of every step. Returns each rank's kernel launches
    (with ``conv3x3_fused_t``'s, the differentiable block conv's), whether
    the state ended bitwise equal on every rank (the pools on every data
    rank), rank 0's ms per step and, per rank, its count of the grads'
    all-reduces (with data ranks: one a net a step) and its peak memory
    allocated (None on the CPU). Under --steps_per_call K the ms are per
    call of K steps."""
    cfg = parse_config(argv, train=True)
    ctx, data = rank_contexts(cfg, n)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_times = []
    state = train_loop(cfg, device, say, ctx, data=data, step_times=step_times)
    launches = [None] * n
    dist.all_gather_object(launches, kernel_counts())
    result = {"launches": launches, "step_ms": [s * 1e3 for s in step_times],
              "params_equal": params_equal_across_ranks(state, RankCtx(n), pools=data)}
    mine = {"grad_reduces": None if data is None else data.grad_reduces,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else None)}
    result["ranks"] = [None] * n
    dist.all_gather_object(result["ranks"], mine)
    for c in (ctx, data):
        if c is not None:
            c.close()
    return result


def main(argv=None, step_times=None):
    """Train on one device; with --data_mesh D > 1 or --spatial_mesh S > 1,
    on D x S spawned ranks (module docstring). Returns the state, or for a
    run on ranks rank 0's result (``train_rank``). ``step_times``: on one
    device, a list that takes each call's seconds (``train_loop``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = parse_config(argv, train=True)
    model = get_model(cfg.model)
    if not hasattr(model, "make_train_step"):
        raise NotImplementedError(f"model {cfg.model!r} does not train (the port trains "
                                  "pix2pix, cycle_gan and template)")
    data_n, spatial_n = mesh_of(cfg)
    if spatial_n > 1:
        sharded_w_mode(cfg)
        if hasattr(model, "check_sharded"):
            model.check_sharded(cfg)
    dataset = create_dataset(cfg, "train" if cfg.val_split > 0 else None)
    cfg.steps_per_epoch = len(dataset)
    print(format_config(cfg))
    save_config(cfg)
    n = data_n * spatial_n
    if n == 1:
        return train_loop(cfg, torch.device(cfg.device), dataset=dataset,
                          step_times=step_times)
    kind = "mesh" if data_n > 1 and spatial_n > 1 else "data" if data_n > 1 else "spatial"
    print(placement(n, cfg.device, kind=kind, spatial=spatial_n))
    if spatial_n > 1:
        for note in spatial_notices(cfg):
            print(note)
    result = spawn(train_rank, n, (argv,), device=cfg.device)
    print(f"{kind}: kernel launches per rank {json.dumps(result['launches'])}")
    for r, got in enumerate(result["ranks"]):
        calls, mem = got["grad_reduces"], got["max_memory_allocated"]
        reduce = "" if calls is None else f"the grads' all-reduce {calls} calls; "
        print(f"{kind}: rank {r}: {reduce}max_memory_allocated "
              f"{'n/a (CPU)' if mem is None else f'{mem / 2**30:.2f} GiB'}")
    print(f"{kind}: parameters bitwise equal on every rank: {result['params_equal']}")
    if not result["params_equal"]:
        raise RuntimeError(f"the ranks' parameters differ after training: the {kind} "
                           "ranks' steps diverged")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
