"""Training CLI: the reference's train.py loop on one device.

  python -m biasgan_tpu_torch.train --model cycle_gan --dataset_mode synthetic \\
      --netG resnet_9blocks --ngf 64 --ndf 64 --crop_size 256 --input_nc 3 \\
      --output_nc 3 --batch_size 1 --compute_dtype bfloat16 --fused_blocks \\
      --name RUN --device cuda

Counterpart of the repo-root ``train.py`` (:130-249), with its flags:
parse the config, build the dataset and the training state, then the epoch
loop (fetch a batch, move it to the device, one optimization step; print
and log the losses, save at the cadences; advance the LR schedule at each
epoch's end). The loss line is the reference's, ``(epoch: E, iters: I,
time: T, data: D) D_A: ... idt_B: ...``, to stdout and
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

Not carried: --steps_per_call (a scan of steps per dispatch), --profile,
the validation metrics and the HTML pages. Only CycleGAN trains so far.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from biasgan_tpu_torch.config import format_config, parse_config, route_on, save_config
from biasgan_tpu_torch.data import create_dataset
from biasgan_tpu_torch.infer import pallas_conv_notices
from biasgan_tpu_torch.models.common import make_lr_schedule, step_generator
from biasgan_tpu_torch.nn.generators import fused_blocks_blocker
from biasgan_tpu_torch.nn.layers import conv7_eligible
from biasgan_tpu_torch.registry import get_model
from biasgan_tpu_torch.utils import checkpoint


def routing_notices(cfg, state) -> list:
    """One line per kernel flag: engaged, or ignored and why."""
    notes = []
    resnet = cfg.netG.startswith("resnet")
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
        for g in ("G_A", "G_B"):
            for conv in ("stem", "head"):
                mod = getattr(state.nets[g], conv, None)
                if mod is None or not conv7_eligible(mod.weight.shape, mod.stride,
                                                     mod.padding):
                    notes.append(f"--conv7_pallas: the {g} {conv} stays on cuDNN — the "
                                 "kernel takes a 7x7 conv with exactly one channel "
                                 "side of at most 8")
        if not any(n.startswith("--conv7_pallas") for n in notes):
            notes.append("--conv7_pallas: engaged (conv7x7 on the stems and heads)")
    if cfg.force_pallas_norm:
        notes.append(
            "--force_pallas_norm: engaged (instance_norm_act on the instance norms "
            "of G and D)" if cfg.norm == "instance" else
            f"--force_pallas_norm: ignored — norm {cfg.norm!r} is not instance norm"
        )
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


def main(argv=None):
    cfg = parse_config(argv, train=True)
    model = get_model(cfg.model)
    if not hasattr(model, "make_train_step"):
        raise NotImplementedError(f"training model {cfg.model!r} is not ported yet "
                                  "(the port trains cycle_gan)")
    device = torch.device(cfg.device)
    dataset = create_dataset(cfg)
    cfg.steps_per_epoch = len(dataset)
    print(format_config(cfg))
    save_config(cfg)
    print(f"The number of training images = {dataset.num_samples}")

    state = model.create_state(cfg, device)
    run_dir = cfg.run_dir()
    host_step = 0
    if cfg.continue_train:
        tag = f"iter_{cfg.load_iter}" if cfg.load_iter > 0 else cfg.epoch
        meta = checkpoint.load_state(run_dir, tag, state)
        host_step = int(meta.get("host_step", state.step))
        print(f"resumed training state {tag!r} at step {state.step}")
    for note in routing_notices(cfg, state):
        print(note)
    step_fn = model.make_train_step(cfg)
    lr_fn = make_lr_schedule(cfg)
    log_name = os.path.join(run_dir, "loss_log.txt")
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
                print(msg)
                with open(log_name, "a") as f:
                    f.write(msg + "\n")
            if total_iters % cfg.save_latest_freq < cfg.batch_size:
                print(f"saving latest (epoch {epoch}, total_iters {total_iters})")
                tag = f"iter_{total_iters}" if cfg.save_by_iter else "latest"
                checkpoint.save_state(run_dir, tag, state, {"host_step": host_step,
                                                            "epoch": epoch})
            t_data_mark = time.time()
        if epoch % cfg.save_epoch_freq == 0:
            print(f"saving model at end of epoch {epoch}, iters {total_iters}")
            meta = {"host_step": host_step, "epoch": epoch}
            checkpoint.save_state(run_dir, "latest", state, meta)
            checkpoint.save_state(run_dir, f"epoch_{epoch}", state, meta)
        if cfg.lr_policy == "plateau":
            # the tracked metric is the validation RMSE, not ported yet
            print("warning: plateau policy found no rmse metric; lr will not decay "
                  "this epoch")
        lr = lr_fn(state.step, state.lr_scale)
        print(f"End of epoch {epoch} / {n_total} \t Time: {time.time() - epoch_start:.1f}s"
              f" \t lr: {lr:.3e}")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
