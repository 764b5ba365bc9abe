"""Training CLI: the reference's train.py loop on one device.

  python -m biasgan_tpu_torch.train --model cycle_gan --dataset_mode synthetic \\
      --netG resnet_9blocks --ngf 64 --ndf 64 --crop_size 256 --input_nc 3 \\
      --output_nc 3 --batch_size 1 --compute_dtype bfloat16 --fused_blocks \\
      --name RUN --device cuda
  python -m biasgan_tpu_torch.train --model pix2pix --dataset_mode synthetic \\
      --compute_dtype bfloat16 --name RUN --device cuda

(pix2pix at the reference's defaults: unet_256 G, basic D, batch norm,
vanilla GAN + L1, dropout on, 256x256.)

Counterpart of the repo-root ``train.py`` (:130-249), with its flags:
parse the config, build the dataset and the training state, then the epoch
loop (fetch a batch, move it to the device, one optimization step; print
and log the losses, save at the cadences; advance the LR schedule at each
epoch's end). The loss line is the reference's, ``(epoch: E, iters: I,
time: T, data: D) G_GAN: ... D_fake: ...`` (CycleGAN: ``D_A: ... idt_B:
...``), to stdout and
``<run_dir>/loss_log.txt``. Saves write the full training state
(``ckpt/<tag>.pt``) and each net's ``<tag>_net_<name>.pth``, which
``python -m biasgan_tpu_torch.infer`` loads; ``--continue_train`` resumes
from the state at ``--epoch`` (with ``--epoch_count`` the next epoch).

The kernel routes are the JAX CLI's flags: --fused_blocks (the block convs
through conv3x3_fused_t: the fused kernel with its exact backward),
--pallas_conv 1 (the block convs and their input gradients through
conv3x3_valid), --conv7_pallas 1 (the 7x7 stem and head through conv7x7)
and --force_pallas_norm (the instance norms of G and D through
instance_norm_act). Each prints whether it engaged, or why not.

--spatial_mesh N (N > 1) trains spatially sharded (the JAX CLI's
``models/base.py:55-100``): N spawned ranks, one process per W shard
(``parallel.mesh``), each building the same state from --seed and reading
the same global batches; each rank runs the step on its W shard
(``models.cyclegan.make_train_step(..., ctx=...)``), and the losses, the
grads and so the updated parameters are the one-device step's. Rank 0
prints the loss lines and writes ``loss_log.txt`` and the checkpoints (the
pools gathered on W); a rank that fails fails the run. Sharding needs a W
pad that does not reflect (--w_pad_mode wrap or zero); --halo_rdma is
ignored, with a notice (the kernel has no backward, and the JAX training
context has no rdma); --fused_blocks takes the block conv's halo W mode.

Not carried: --steps_per_call (a scan of steps per dispatch), --profile,
--data_mesh, the validation metrics and the HTML pages. pix2pix trains on
one device (``models.pix2pix``; its sharded step is not ported yet and
raises), CycleGAN on one device or sharded.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
import torch.distributed as dist

from biasgan_tpu_torch.config import format_config, parse_config, route_on, save_config
from biasgan_tpu_torch.data import create_dataset
from biasgan_tpu_torch.infer import pallas_conv_notices
from biasgan_tpu_torch.models.common import make_lr_schedule, step_generator
from biasgan_tpu_torch.nn.generators import fused_blocks_blocker
from biasgan_tpu_torch.nn.layers import conv7_eligible
from biasgan_tpu_torch.parallel import HaloCtx, placement, spawn
from biasgan_tpu_torch.parallel.checks import kernel_counts
from biasgan_tpu_torch.registry import get_model
from biasgan_tpu_torch.utils import checkpoint


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


def format_losses(epoch, iters, losses, t_comp, t_data) -> str:
    """The reference's loss line."""
    msg = f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, data: {t_data:.3f}) "
    return msg + " ".join(f"{k}: {v:.3f}" for k, v in losses.items())


def sharded_w_mode(cfg) -> str:
    """The generator's W pad mode as --w_pad_mode resolves it (the resnets
    reflect by default); raises where it reflects, which cannot shard."""
    w_mode = cfg.w_pad_mode or "reflect"
    if w_mode == "reflect":
        raise ValueError(
            f"--spatial_mesh {cfg.spatial_mesh} shards the width axis, which cannot be "
            f"reflect-padded: --w_pad_mode {cfg.w_pad_mode or '(unset: reflect)'}; pass "
            "--w_pad_mode wrap (periodic longitude) or --w_pad_mode zero"
        )
    return w_mode


def train_loop(cfg, device: torch.device, say=print, ctx=None, dataset=None):
    """The reference's epoch loop on ``device`` (module docstring) over
    ``dataset`` (made from ``cfg`` unless given): state, resume, the steps,
    the loss lines, the saves. Under a spatial context ``ctx`` this is one
    rank of a sharded run: every rank steps, only rank 0's ``say`` prints,
    and only rank 0 writes. Returns the state."""
    model = get_model(cfg.model)
    writes = ctx is None or ctx.rank == 0
    if dataset is None:
        dataset = create_dataset(cfg)
    cfg.steps_per_epoch = len(dataset)
    say(f"The number of training images = {dataset.num_samples}")

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
    step_fn = model.make_train_step(cfg, ctx=ctx)
    lr_fn = make_lr_schedule(cfg)
    log_name = os.path.join(run_dir, "loss_log.txt")
    if writes:
        with open(log_name, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    total_iters = host_step * cfg.batch_size
    n_total = cfg.n_epochs + cfg.n_epochs_decay
    for epoch in range(cfg.epoch_count, n_total + 1):
        epoch_start = time.time()
        dataset.epoch = epoch - 1  # the shuffle order of this epoch
        t_data_mark = time.time()
        for data in dataset:
            t_data = time.time() - t_data_mark
            iter_start = time.time()
            total_iters += cfg.batch_size
            batch = batch_to(data, device)
            losses, _ = step_fn(state, batch, step_generator(cfg.seed, host_step))
            host_step += 1
            if total_iters % cfg.print_freq < cfg.batch_size:
                values = {k: float(v) for k, v in losses.items()}  # syncs the device
                sync()
                t_comp = (time.time() - iter_start) / cfg.batch_size
                msg = format_losses(epoch, total_iters, values, t_comp, t_data)
                say(msg)
                if writes:
                    with open(log_name, "a") as f:
                        f.write(msg + "\n")
            if total_iters % cfg.save_latest_freq < cfg.batch_size:
                say(f"saving latest (epoch {epoch}, total_iters {total_iters})")
                tag = f"iter_{total_iters}" if cfg.save_by_iter else "latest"
                checkpoint.save_state(run_dir, tag, state, {"host_step": host_step,
                                                            "epoch": epoch}, ctx)
            t_data_mark = time.time()
        if epoch % cfg.save_epoch_freq == 0:
            say(f"saving model at end of epoch {epoch}, iters {total_iters}")
            meta = {"host_step": host_step, "epoch": epoch}
            checkpoint.save_state(run_dir, "latest", state, meta, ctx)
            checkpoint.save_state(run_dir, f"epoch_{epoch}", state, meta, ctx)
        if cfg.lr_policy == "plateau":
            # the tracked metric is the validation RMSE, not ported yet
            say("warning: plateau policy found no rmse metric; lr will not decay "
                "this epoch")
        lr = lr_fn(state.step, state.lr_scale)
        say(f"End of epoch {epoch} / {n_total} \t Time: {time.time() - epoch_start:.1f}s"
            f" \t lr: {lr:.3e}")
    return state


def params_equal_across_ranks(state, ctx) -> bool:
    """Whether every net's parameters on every rank equal rank 0's,
    bitwise (collective)."""
    return ctx.same_on_every_rank(torch.cat([
        p.detach().reshape(-1) for net in state.nets.values() for p in net.parameters()]))


def train_rank(rank, n, device, say, argv):
    """One rank of a sharded run (``parallel.spawn``): the command line's
    config, its W shard of every step. Returns each rank's kernel launches
    (with ``conv3x3_fused_t``'s, the differentiable block conv's) and
    whether the parameters ended bitwise equal on every rank."""
    cfg = parse_config(argv, train=True)
    ctx = HaloCtx(n, periodic=sharded_w_mode(cfg) == "wrap")
    state = train_loop(cfg, device, say, ctx)
    launches = [None] * n
    dist.all_gather_object(launches, kernel_counts())
    equal = params_equal_across_ranks(state, ctx)
    ctx.close()
    return {"launches": launches, "params_equal": equal}


def main(argv=None):
    """Train on one device; with --spatial_mesh N > 1, on N spawned ranks
    (module docstring). Returns the state, or for a sharded run rank 0's
    result (``train_rank``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = parse_config(argv, train=True)
    model = get_model(cfg.model)
    if not hasattr(model, "make_train_step"):
        raise NotImplementedError(f"training model {cfg.model!r} is not ported yet "
                                  "(the port trains pix2pix and cycle_gan)")
    n = max(cfg.spatial_mesh, 1)
    if n > 1 and cfg.model != "cycle_gan":
        raise NotImplementedError(f"sharded training of model {cfg.model!r} is not ported "
                                  "yet (--spatial_mesh > 1 trains cycle_gan)")
    if n > 1:
        sharded_w_mode(cfg)
    dataset = create_dataset(cfg)
    cfg.steps_per_epoch = len(dataset)
    print(format_config(cfg))
    save_config(cfg)
    if n == 1:
        return train_loop(cfg, torch.device(cfg.device), dataset=dataset)
    print(placement(n, cfg.device))
    for note in spatial_notices(cfg):
        print(note)
    result = spawn(train_rank, n, (argv,), device=cfg.device)
    print(f"spatial: kernel launches per rank {json.dumps(result['launches'])}")
    print(f"spatial: parameters bitwise equal on every rank: {result['params_equal']}")
    if not result["params_equal"]:
        raise RuntimeError("the ranks' parameters differ after training: the sharded "
                           "steps diverged")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
