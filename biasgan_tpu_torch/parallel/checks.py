"""Rank programs that hold the spatially sharded path to what it must equal,
for ``parallel.mesh.spawn``. The CPU tests spawn them (their ranks import
torch and the port only, never JAX) and ``chip_smoke.py`` runs them on the
card. Each is ``fn(rank, n, device, say, *args)`` with numpy in and out;
rank 0's return value is the result.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from biasgan_tpu_torch.kernels import launch_counts
from biasgan_tpu_torch.parallel.spatial import HaloCtx, shard_w, spatial_apply


def halo_cases(rank, n, device, say, x: np.ndarray, cases: Sequence[Tuple[int, int, bool]]):
    """For each ``(left, right, periodic)`` and each transport (the plain
    ring; ``rdma``: the ``halo_exchange_w`` wrapper), this rank's W shard of
    the global NHWC ``x`` through ``HaloCtx.pad_w``, the padded shards
    concatenated along W on rank 0: ``{(left, right, periodic, rdma):
    array}``. Under ``"guard"``, the message of the ValueError that a halo
    one column wider than the shard raises."""
    xt = torch.from_numpy(x).to(device)
    out: Dict = {}
    with torch.inference_mode():
        for left, right, periodic in cases:
            for rdma in (False, True):
                ctx = HaloCtx(n, periodic, rdma)
                y = ctx.gather_w(ctx.pad_w(shard_w(xt, ctx), left, right))
                ctx.close()
                if rank == 0:
                    out[(left, right, periodic, rdma)] = y.cpu().numpy()
        ctx = HaloCtx(n, True, True)
        xl = shard_w(xt, ctx)
        try:
            ctx.pad_w(xl, xl.shape[2] + 1, 0)
        except ValueError as e:
            out["guard"] = str(e)
    return out


def generator_cases(rank, n, device, say, spec: dict, state: Dict[str, np.ndarray],
                    x: np.ndarray, cases: Sequence[dict]):
    """For each case ``{"w_mode": 'wrap' | 'zero', "fused": bool, "rdma":
    bool}``: ``define_G(**spec, w_mode=..., fused_blocks=...)`` with the
    weights ``state``, in eval mode on ``device``, through ``spatial_apply``
    on the global NHWC ``x``. Returns ``{"outputs": [rank 0's gathered
    output per case], "launches": [each rank's kernel launches]}``."""
    from biasgan_tpu_torch.nn import define_G

    xt = torch.from_numpy(x).to(device)
    outputs: List = []
    with torch.inference_mode():
        for case in cases:
            G = define_G(**spec, w_mode=case["w_mode"], fused_blocks=case["fused"])
            G.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
            G = G.to(device).eval()
            ctx = HaloCtx(n, case["w_mode"] == "wrap", case["rdma"])
            y = spatial_apply(G, ctx)(xt)
            ctx.close()
            outputs.append(None if y is None else y.cpu().numpy())
    launches = [None] * n
    dist.all_gather_object(launches, launch_counts())
    return {"outputs": outputs, "launches": launches}
