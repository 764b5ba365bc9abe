"""Checkpoints: per-network weights in the reference family's own format,
and the full training state.

* One plain ``state_dict`` per network, ``<run_dir>/<tag>_net_<name>.pth``:
  what ``python -m biasgan_tpu_torch.infer`` loads (a weights file from a
  JAX checkpoint is made with ``convert.params_to_state_dict``).
* The full training state, ``<run_dir>/ckpt/<tag>.pt``: every net, both
  Adam states, the step, the LR scale and the replay pools, with the
  training loop's epoch and step count. Counterpart of the JAX package's
  ``utils/checkpoint.py::save_state`` (:49): an overwrite renames the
  committed file aside to ``<tag>.pt.old`` before the new one lands, and a
  load falls back to it, so a kill mid-save leaves a restorable state.

A spatially sharded run (a ``parallel.spatial.HaloCtx``) saves from rank 0
the checkpoint of the one-device run: the nets are the same on every rank,
and the replay pools, which each rank holds for its W shard, are gathered
on W. A load under a context takes each rank's W shard of the pools, so
either run resumes from either's checkpoint.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

from biasgan_tpu_torch.parallel.spatial import shard_w


def load_tag(epoch: str, load_iter: int = 0) -> str:
    """Reference load suffix: ``iter_<N>`` when --load_iter > 0, else
    --epoch."""
    return f"iter_{load_iter}" if load_iter > 0 else str(epoch)


def network_path(run_dir: str, tag: str, name: str) -> str:
    return os.path.join(run_dir, f"{tag}_net_{name}.pth")


def save_network(net: nn.Module, run_dir: str, tag: str, name: str) -> str:
    """Save ``net``'s state_dict (on the CPU) to ``<tag>_net_<name>.pth``,
    written under a temporary name and renamed, so a kill never leaves a
    truncated file under the final name."""
    path = network_path(run_dir, tag, name)
    os.makedirs(run_dir, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)
    return path


def load_network(net: nn.Module, run_dir: str, tag: str, name: str) -> str:
    """Load ``<tag>_net_<name>.pth`` into ``net`` (strict: every key must
    match). Returns the path."""
    path = network_path(run_dir, tag, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint for net {name!r} at {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net.load_state_dict(sd)
    return path


def state_path(run_dir: str, tag: str) -> str:
    return os.path.join(run_dir, "ckpt", f"{tag}.pt")


def save_state(run_dir: str, tag: str, state, meta: Optional[Dict] = None, ctx=None) -> str:
    """Save the full training state (``models.common.GANTrainState``) and
    ``meta`` under ``<run_dir>/ckpt/<tag>.pt``, the committed file renamed
    aside first; also each net's ``<tag>_net_<name>.pth``. Under a spatial
    context ``ctx`` every rank calls it (the pools are gathered) and rank 0
    writes."""
    path = state_path(run_dir, tag)
    pools = {k: {"buffer": p.buffer if ctx is None else ctx.gather_w(p.buffer),
                 "count": p.count} for k, p in state.pools.items()}
    if ctx is not None and ctx.rank != 0:
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = {
        "step": state.step,
        "lr_scale": state.lr_scale,
        "nets": {k: {n: t.detach().cpu() for n, t in v.state_dict().items()}
                 for k, v in state.nets.items()},
        "opts": {k: {"count": o.count,
                     "mu": {n: t.cpu() for n, t in o.mu.items()},
                     "nu": {n: t.cpu() for n, t in o.nu.items()}}
                 for k, o in state.opts.items()},
        "pools": {k: {"buffer": p["buffer"].cpu(), "count": p["count"]}
                  for k, p in pools.items()},
        "meta": dict(meta or {}),
    }
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    if os.path.exists(path):
        os.replace(path, path + ".old")
    os.replace(tmp, path)
    for name, net in state.nets.items():
        save_network(net, run_dir, tag, name)
    return path


def load_state(run_dir: str, tag: str, state, ctx=None) -> Dict:
    """Load ``<run_dir>/ckpt/<tag>.pt`` (or its ``.old``, where a save was
    cut) into ``state`` in place, on the devices its tensors are on; returns
    the saved meta. Under a spatial context ``ctx``, each pool takes this
    rank's W shard."""
    path = state_path(run_dir, tag)
    if not os.path.exists(path):
        path += ".old"
    if not os.path.exists(path):
        raise FileNotFoundError(f"no training state at {state_path(run_dir, tag)}")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state.step = int(blob["step"])
    state.lr_scale = float(blob["lr_scale"])
    for k, sd in blob["nets"].items():
        state.nets[k].load_state_dict(sd)
    for k, o in blob["opts"].items():
        state.opts[k].load_state_dict(o)
    for k, p in blob["pools"].items():
        state.pools[k].buffer.copy_(p["buffer"] if ctx is None else shard_w(p["buffer"], ctx))
        state.pools[k].count = int(p["count"])
    return blob["meta"]
