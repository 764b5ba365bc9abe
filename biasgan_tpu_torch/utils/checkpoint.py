"""Network checkpoints in the reference family's own format: one plain
``state_dict`` per network, saved as ``<run_dir>/<epoch>_net_<name>.pth``.

Takes over the network-loading job of ``biasgan_tpu/models/base.py``
(``save_networks`` / ``load_networks``) for the port; the JAX package's
full-train-state orbax checkpoints (utils/checkpoint.py there) arrive with
the training slices. A weights file from a JAX checkpoint is made with
``convert.params_to_state_dict``.
"""

from __future__ import annotations

import os

import torch
from torch import nn


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
