"""Test driver: apply a trained model to a dataset and write its result
images and an HTML page.

  python -m biasgan_tpu_torch.test --model pix2pix --dataroot DATA --name RUN \\
      [--eval] [--num_test 50] [--results_dir ./results] [--device cuda]
  python -m biasgan_tpu_torch.test --model test --model_suffix _A \\
      --dataset_mode single --dataroot DATA/testA --name CYCLEGAN_RUN \\
      --fused_blocks --fused_updown --conv7_pallas 1 --eval

Counterpart of the repo-root ``test.py`` (:26-60): parse the test
options, print and save them, fail with a SystemExit naming the missing
checkpoint before anything is built, build the dataset and the model's G
forwards on --device (the card unless the caller asks for the CPU), then
for each sample up to --num_test move the batch to the device, run the
forward and write its visuals as ``images/<name>_<label>.png`` rows of
``<results_dir>/<name>/<phase>_<epoch>/index.html`` (``save_images``).
It prints ``processing (%04d)-th image... [path]`` every fifth sample,
with that forward's ms, timed host to host (the device synchronised).

The models: pix2pix (real_A, fake_B, real_B), cycle_gan (real_A, fake_B,
rec_A, real_B, fake_A, rec_B), test (real, fake; --model_suffix _A loads
a CycleGAN run's G_A) and template (as pix2pix). Their Gs load from
``<checkpoints_dir>/<name>/<epoch>_net_<G>.pth`` and are built as
``infer.build_generator`` builds them, so the kernel routes
(--fused_blocks, --fused_updown, --conv7_pallas 1, --force_pallas_norm,
--pallas_conv 1) engage as in ``infer``; each flag that cannot engage
says why.

Without --eval the forward runs in training mode, the reference's
default: batch statistics, and dropout with fresh masks per forward from a
generator seeded by --seed and the forward's count (``eval_generator``,
off the training stream); G's running averages stay as they were (the
JAX model drops their update). The fused down and up kernels have no
training-mode path, so --fused_updown engages only with --eval. With
--eval the running averages normalize and no unit drops.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Optional

import torch

from biasgan_tpu_torch.config import format_config, parse_config, save_config
from biasgan_tpu_torch.data import create_dataset
from biasgan_tpu_torch.infer import load_generator, routing_notices
from biasgan_tpu_torch.models.common import GANTrainState, eval_generator
from biasgan_tpu_torch.registry import get_model
from biasgan_tpu_torch.train import batch_to
from biasgan_tpu_torch.utils import checkpoint


def missing_checkpoint(cfg) -> Optional[str]:
    """The path of the first G checkpoint of the run that is not on disk,
    or None."""
    tag = checkpoint.load_tag(cfg.epoch, cfg.load_iter)
    for name, _, _ in get_model(cfg.model).test_nets(cfg).values():
        path = checkpoint.network_path(cfg.run_dir(), tag, name)
        if not os.path.exists(path):
            return path
    return None


def build_state(cfg, device: torch.device, say=print) -> GANTrainState:
    """The model's Gs on ``device`` with their checkpoints loaded, on every
    kernel route of the configuration (module docstring); no optimizer."""
    nets = {slot: load_generator(cfg, name, cin, cout, device, say)
            for slot, (name, cin, cout) in get_model(cfg.model).test_nets(cfg).items()}
    return GANTrainState(step=0, lr_scale=1.0, nets=nets, opts={})


def test_notices(cfg, G) -> list:
    """``infer.routing_notices`` for the forward the test driver runs, on one
    device: without --eval a training-mode one, where --fused_updown
    cannot engage; --spatial_mesh and --halo_rdma do not apply."""
    one = dataclasses.replace(cfg, spatial_mesh=1, halo_rdma=False,
                              fused_updown=cfg.fused_updown and cfg.eval)
    notes = routing_notices(one, G)
    if cfg.fused_updown and not cfg.eval:
        notes.append("--fused_updown: ignored without --eval — the test forward runs in "
                     "training mode (batch statistics), where the fused down/up kernels do "
                     "not engage (as in JAX)")
    for flag, on in (("--spatial_mesh", cfg.spatial_mesh > 1), ("--halo_rdma", cfg.halo_rdma)):
        if on:
            notes.append(f"{flag}: ignored — the test driver runs on one device, as the JAX "
                         "test.py; sharded serving is python -m biasgan_tpu_torch.infer "
                         "--spatial_mesh N")
    return notes


def run(cfg, device: torch.device, pages: bool = True, say=print,
        on_sample: Optional[Callable] = None) -> dict:
    """The test driver's loop (module docstring) on ``device``. ``pages``:
    write the images and ``index.html`` (PIL); ``on_sample(i, visuals,
    paths)``: called with each sample's visuals (device tensors). Returns
    the page's directory (``web_dir``), each forward's ms (``ms``) and the
    state."""
    dataset = create_dataset(cfg)
    state = build_state(cfg, device, say)
    for note in test_notices(cfg, next(iter(state.nets.values()))):
        say(note)
    eval_fn = get_model(cfg.model).make_eval_fn(cfg)
    web_dir = os.path.join(cfg.results_dir, cfg.resolved_name(), f"{cfg.phase}_{cfg.epoch}")
    webpage = None
    if pages:
        from biasgan_tpu_torch.utils import html as html_mod
        from biasgan_tpu_torch.utils.visualizer import save_images

        say(f"creating web directory {web_dir}")
        webpage = html_mod.HTML(
            web_dir, f"Experiment = {cfg.name}, Phase = {cfg.phase}, Epoch = {cfg.epoch}")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    times = []
    for i, data in enumerate(dataset):
        if cfg.num_test and i >= cfg.num_test:
            break
        batch = batch_to(data, device)
        paths = data.get("A_paths", data.get("B_paths", []))
        sync()
        t0 = time.perf_counter()
        visuals = eval_fn(state, batch, eval_generator(cfg.seed, i + 1), train=not cfg.eval)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        if i % 5 == 0:
            say(f"processing ({i:04d})-th image... {paths} (forward {times[-1]:.3f} ms)")
        if on_sample is not None:
            on_sample(i, visuals, paths)
        if webpage is not None:
            save_images(webpage, visuals, paths, aspect_ratio=cfg.aspect_ratio)
    if webpage is not None:
        webpage.save()
    return {"web_dir": web_dir, "ms": times, "state": state}


def prepare(argv):
    """Parse the test options of ``argv``, print and save them, and raise a
    SystemExit naming a missing checkpoint before anything is built.
    Returns the config."""
    cfg = parse_config(argv, train=False)
    print(format_config(cfg))
    save_config(cfg)
    path = missing_checkpoint(cfg)
    if path is not None:
        tag = checkpoint.load_tag(cfg.epoch, cfg.load_iter)
        raise SystemExit(
            f"no checkpoint '{tag}' under {cfg.run_dir()} ({path} is missing) — train "
            "first or check --name/--checkpoints_dir/--epoch/--model_suffix")
    return cfg


def main(argv=None) -> str:
    """Run the test driver on the command line ``argv``; returns the page's
    directory."""
    cfg = prepare(sys.argv[1:] if argv is None else list(argv))
    return run(cfg, torch.device(cfg.device))["web_dir"]


if __name__ == "__main__":
    main(sys.argv[1:])
