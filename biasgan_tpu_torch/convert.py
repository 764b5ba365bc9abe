"""JAX parameter trees <-> port ``state_dict``s.

The JAX package holds a generator's weights as nested dicts (``params``,
plus ``batch_stats`` under batch norm) in its layout:
  conv      kernel[kh, kw, ic, oc]  (HWIO)
  convT     kernel[kh, kw, ic, oc]  (HWIO, flipped in-graph)
  batchnorm <path>/BatchNorm_0/{scale, bias} and batch_stats .../{mean, var}
The port holds them in the torch layout under torch module names:
  conv      <prefix>.weight[oc, ic, kh, kw]  (OIHW)
  convT     <prefix>.weight[ic, oc, kh, kw]  (IOHW; the up{k} modules)
  batchnorm <prefix>.{weight, bias, running_mean, running_var,
            num_batches_tracked}

``state_dict_to_params`` is the exact counterpart of
``biasgan_tpu/utils/torch_import.py::convert_state_dict``;
``params_to_state_dict`` is its inverse. Both only transpose, so a round
trip is bit-exact. Names follow the torch-oracle naming: the ResNet
generator's ``blocks.{i}.conv{j}`` <-> ``block{i}/conv{j}``, the
discriminators' ``convs.{n}`` / ``norms.{n}`` / ``out`` <-> ``conv{n}`` /
``norm{n}`` / ``conv_out``, the U-Net's ``downs.{i}`` / ``down_norms.{i}``
/ ``ups.{i}`` / ``up_norms.{i}`` <-> ``down{i}`` / ``down_norm{i}`` /
``up{i}`` / ``up_norm{i}``, every other module the same on both sides. The
tree names alone do not tell a U-Net's ``down0`` from the ResNet's, so a
tree without a ``stem`` (the ResNet's 7x7 input conv) whose modules include
a ``down{i}`` is taken for a U-Net's.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# tree path <-> torch module prefix: the resnet blocks, the discriminators'
# conv{n} / norm{n} / conv_out, every other module the same on both sides
_UNET_TO_TORCH = (
    (r"^(down|up)(\d+)$", r"\1s.\2"),
    (r"^(down|up)_norm(\d+)$", r"\1_norms.\2"),
)
_TO_TORCH = (
    (r"^block(\d+)/(conv|norm)(\d+)$", r"blocks.\1.\2\3"),
    (r"^(conv|norm)(\d+)$", r"\1s.\2"),
    (r"^conv_out$", r"out"),
    (r"^([A-Za-z_0-9]+)$", r"\1"),
)
_TO_TREE = (
    (r"^(down|up)s\.(\d+)$", r"\1\2"),
    (r"^(down|up)_norms\.(\d+)$", r"\1_norm\2"),
    (r"^blocks\.(\d+)\.(conv|norm)(\d+)$", r"block\1/\2\3"),
    (r"^(conv|norm)s\.(\d+)$", r"\1\2"),
    (r"^out$", r"conv_out"),
    (r"^([A-Za-z_0-9]+)$", r"\1"),
)
_BN = "BatchNorm_0"
_PARAM_SUFFIXES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _rename(name: str, rules) -> str:
    for pat, repl in rules:
        if re.match(pat, name):
            return re.sub(pat, repl, name)
    raise KeyError(f"no rule maps module {name!r}")


def _is_convT(path: str, transpose_prefixes: Tuple[str, ...]) -> bool:
    """Whether the tree module ``path`` is a conv-transpose: its name is a
    prefix and an index (``up1``; not ``up_norm1``)."""
    name = path.split("/")[-1]
    return any(re.fullmatch(re.escape(p) + r"\d*", name) for p in transpose_prefixes)


def _tree_rules(params: Mapping):
    """The tree -> torch rules for ``params``: a U-Net's (no ``stem``, a
    ``down{i}``) first."""
    names = set(params)
    unet = "stem" not in names and any(re.fullmatch(r"down\d+", n) for n in names)
    return (_UNET_TO_TORCH if unet else ()) + _TO_TORCH


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _set(tree: Dict, path: str, leaf_name: str, value: np.ndarray) -> None:
    node = tree
    for part in path.split("/"):
        node = node.setdefault(part, {})
    node[leaf_name] = value


def params_to_state_dict(
    params: Mapping,
    batch_stats: Optional[Mapping] = None,
    transpose_prefixes: Tuple[str, ...] = ("up",),
) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``params`` (+ ``batch_stats``) trees of numpy arrays -> a port
    ``state_dict``. ``transpose_prefixes``: tree modules whose name starts
    with one of these are conv-transposes (HWIO -> IOHW)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    rules = _tree_rules(params)
    for key, v in _flatten(params).items():
        *mod, leaf = key.split("/")
        if mod and mod[-1] == _BN:
            prefix = _rename("/".join(mod[:-1]), rules)
            name = {"scale": "weight", "bias": "bias"}[leaf]
            sd[f"{prefix}.{name}"] = torch.from_numpy(np.array(v, np.float32))
            continue
        path = "/".join(mod)
        prefix = _rename(path, rules)
        if leaf == "kernel":
            axes = (2, 3, 0, 1) if _is_convT(path, transpose_prefixes) else (3, 2, 0, 1)
            w = np.ascontiguousarray(np.asarray(v, np.float32).transpose(axes))
            sd[f"{prefix}.weight"] = torch.from_numpy(w)
        elif leaf == "bias":
            sd[f"{prefix}.bias"] = torch.from_numpy(np.array(v, np.float32))
        else:
            raise KeyError(f"unrecognized parameter {key!r}")
    for key, v in _flatten(batch_stats or {}).items():
        *mod, leaf = key.split("/")
        if not mod or mod[-1] != _BN or leaf not in ("mean", "var"):
            raise KeyError(f"unrecognized batch statistic {key!r}")
        prefix = _rename("/".join(mod[:-1]), rules)
        sd[f"{prefix}.running_{leaf}"] = torch.from_numpy(np.array(v, np.float32))
        if leaf == "mean":
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def state_dict_to_params(
    sd: Mapping[str, torch.Tensor],
    transpose_prefixes: Tuple[str, ...] = ("up",),
) -> Tuple[Dict, Dict]:
    """A port ``state_dict`` -> JAX (params, batch_stats) trees of numpy
    arrays — what ``convert_state_dict`` gives for the same weights."""
    modules: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in sd.items():
        for suf in _PARAM_SUFFIXES:
            if key.endswith("." + suf):
                prefix = key[: -len(suf) - 1]
                break
        else:
            raise ValueError(f"unrecognized state_dict key {key!r}")
        t = val.detach().cpu() if isinstance(val, torch.Tensor) else torch.as_tensor(val)
        modules.setdefault(prefix, {})[suf] = t.numpy()

    params: Dict = {}
    stats: Dict = {}
    for prefix, entries in modules.items():
        path = _rename(prefix, _TO_TREE)
        if "running_mean" in entries:  # a batch norm
            base = f"{path}/{_BN}"
            _set(params, base, "scale", entries["weight"].astype(np.float32))
            _set(params, base, "bias", entries["bias"].astype(np.float32))
            _set(stats, base, "mean", entries["running_mean"].astype(np.float32))
            _set(stats, base, "var", entries["running_var"].astype(np.float32))
            continue
        w = entries.get("weight")
        if w is None or w.ndim != 4:
            raise ValueError(f"{prefix}: unsupported module shape")
        axes = (2, 3, 0, 1) if _is_convT(path, transpose_prefixes) else (2, 3, 1, 0)
        _set(params, path, "kernel", np.ascontiguousarray(w.transpose(axes), np.float32))
        if "bias" in entries:
            _set(params, path, "bias", entries["bias"].astype(np.float32))
    return params, stats
