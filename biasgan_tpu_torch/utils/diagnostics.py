"""Network diagnostics and NaN guards (the reference's
util.diagnose_network, and the --check_finite sanitizer). Counterpart of
``biasgan_tpu/utils/diagnostics.py``, with its values and messages, over
torch modules, state dicts and nested dicts of tensors."""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch import nn


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a module (its state dict), a dict, a list or a tuple,
    in order, as tensors (numpy arrays converted)."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "dtype") and hasattr(tree, "shape"):
        return [torch.as_tensor(tree)]
    return []


def diagnose_network(net: Any, name: str = "network") -> float:
    """The mean absolute value over a network's parameters (the reference
    prints the mean |grad|: pass the grads). ``net``: a module (its
    parameters), or a dict of tensors (its 'params' where it has one).
    Prints the name and the value; returns the value."""
    if isinstance(net, nn.Module):
        leaves = [p.detach() for p in net.parameters()]
    else:
        leaves = _leaves(net.get("params", net) if isinstance(net, dict) else net)
    if not leaves:
        print(f"{name}: <no arrays>")
        return 0.0
    total = sum(torch.sum(torch.abs(x.float())) for x in leaves)
    count = sum(x.numel() for x in leaves)
    mean = float(total / count)
    print(name)
    print(mean)
    return mean


def count_nonfinite(tree: Any) -> Dict[str, int]:
    """The number of NaN / Inf entries under each top-level key of a dict
    (a module or tensor otherwise counts as 'tree'): a quick hunt over
    parameters, grads or activations."""
    items = tree.items() if isinstance(tree, dict) else [("tree", tree)]
    return {key: int(sum(int((~torch.isfinite(x.float())).sum()) for x in _leaves(sub)))
            for key, sub in items}


def assert_finite(tree: Any, where: str = "") -> None:
    """Raise FloatingPointError if any tensor of ``tree`` holds NaN / Inf
    (a host-side check)."""
    bad = {k: v for k, v in count_nonfinite(tree).items() if v}
    if bad:
        raise FloatingPointError(f"non-finite values {bad} {('in ' + where) if where else ''}")


def check_losses_finite(losses: Dict[str, float], where: str = "") -> None:
    """The training loop's guard (--check_finite N): raise naming the
    non-finite loss keys of ``losses`` (host floats)."""
    bad = [k for k, v in losses.items() if not math.isfinite(v)]
    if bad:
        raise FloatingPointError(
            f"non-finite loss{'es' if len(bad) > 1 else ''} {bad}"
            f"{(' at ' + where) if where else ''} — a NaN/Inf has entered "
            "the optimization (try --debug_nans to locate the producing op)"
        )
