"""Explicit per-axis padding of NHWC tensors with ``jnp.pad`` semantics.

Counterpart of ``_pad_axis`` / ``pad_hw`` in ``biasgan_tpu/nn/layers.py``
(:63-97). It lives below nn/ and kernels/ because both pad: the layers
before their convs, and the plain version of the fused block conv.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from biasgan_tpu_torch.trace import span

PAD_MODES = ("zero", "reflect", "wrap")


def pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Pad one axis of ``x`` by (lo, hi) with 'zero' | 'reflect' | 'wrap'."""
    if lo == 0 and hi == 0:
        return x
    if mode == "zero":
        pad = [0, 0] * (x.ndim - 1 - axis) + [lo, hi]
        return F.pad(x, pad)
    if mode not in ("reflect", "wrap"):
        raise ValueError(f"unknown pad mode {mode!r}; expected one of {PAD_MODES}")
    with span("port.pad"):
        # numpy's own index arithmetic gives jnp.pad's semantics for any width
        # (a wrap or reflect wider than the axis repeats, where F.pad refuses)
        idx = np.pad(np.arange(x.shape[axis]), (lo, hi), mode=mode)
        return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def pad_hw(
    x: torch.Tensor,
    pad_h: Tuple[int, int],
    pad_w: Tuple[int, int],
    h_mode: str = "zero",
    w_mode: str = "zero",
    ctx=None,
) -> torch.Tensor:
    """Pad H (axis 1) and W (axis 2) of an NHWC tensor, each with its own
    mode: 'zero' | 'reflect' | 'wrap'. With a spatial context ``ctx``
    (``parallel.spatial.HaloCtx``: W is sharded), W is padded by halo
    exchange, whose edge rule (periodic or zero) is the context's; a
    reflect pad of a sharded W raises."""
    x = pad_axis(x, 1, pad_h[0], pad_h[1], h_mode)
    if ctx is None:
        return pad_axis(x, 2, pad_w[0], pad_w[1], w_mode)
    if w_mode == "reflect":
        raise NotImplementedError(
            "reflect padding on a sharded width axis is not supported; use "
            "'zero' or 'wrap' (periodic longitude)"
        )
    return ctx.pad_w(x, pad_w[0], pad_w[1])
