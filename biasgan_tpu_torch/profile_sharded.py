"""Where the time of a spatially sharded full-globe forward goes, on the
CUDA devices of this host:

    python -m biasgan_tpu_torch.profile_sharded [--out FILE.json]

N_RANKS ranks are spawned as ``infer --spatial_mesh 4`` spawns them
(``parallel.spawn``: rank r on cuda:(r % device count), NCCL when every
rank has a card of its own, else gloo with host-staged collectives), on
three paths: the plain ring (``--spatial_mesh 4``), the halo kernel
(``--halo_rdma``) and the halo kernel with the fused blocks (``--halo_rdma
--fused_blocks``). The model is resnet_9blocks (ngf 64, instance norm,
periodic W, bf16 compute) with random weights from a fixed seed, on a
random (1, 724, W, 3) field, W being 1440 padded to the path's multiple
(``infer.pad_multiples``). Each rank, after a warm-up forward, measures:

* wall: FORWARDS forwards through ``spatial_apply``, host ms per forward;
* instrumented: the same forwards through a ``TimedHaloCtx``, the host time
  spent in each context method (each call between device syncs): the
  exchanges (``pad_w``), the norms' collectives (``mean_w``, ``sum_w``)
  and the gather (``gather_w``);
* profile: ``torch.profiler`` over FORWARDS forwards: each rank's device
  busy ms per forward (kernel self time), and rank 0's largest kernels.

The idle share is 1 - (the ranks' busy time) / (cards x wall). Under NCCL a
collective's kernel counts as busy while it waits on its peers. It prints
one line per path and, with --out, writes every number to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from biasgan_tpu_torch.parallel import HaloCtx, spatial_apply

GLOBE_H, GLOBE_W, N_VARS = 724, 1440, 3  # H 721 padded to the multiple of 4
N_RANKS, FORWARDS, TOP = 4, 3, 6
# path -> (fused_blocks, halo_rdma)
PATHS = {
    "spatial": (False, False),
    "spatial_rdma": (False, True),
    "spatial_rdma_fused": (True, True),
}


class TimedHaloCtx(HaloCtx):
    """A ``HaloCtx`` that adds the host time of each call of its collective
    methods, between device syncs, to ``spent``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.spent = dict.fromkeys(("pad_w", "mean_w", "sum_w", "gather_w"), 0.0)

    def _timed(self, name, method, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = method(*args, **kw)
        torch.cuda.synchronize()
        self.spent[name] += time.perf_counter() - t0
        return out

    def pad_w(self, x, left, right):
        return self._timed("pad_w", super().pad_w, x, left, right)

    def mean_w(self, *xs, dims=(1, 2)):
        return self._timed("mean_w", super().mean_w, *xs, dims=dims)

    def sum_w(self, t):
        return self._timed("sum_w", super().sum_w, t)

    def gather_w(self, y):
        return self._timed("gather_w", super().gather_w, y)


def breakdown_rank(rank, n, device, say, width, fused, rdma):
    """One rank of one path (``parallel.spawn``); returns its numbers,
    with every rank's device busy time."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from biasgan_tpu_torch.nn import define_G
    from biasgan_tpu_torch.profile_globe import _device_rows

    G = define_G("resnet_9blocks", N_VARS, N_VARS, ngf=64, norm="instance", w_mode="wrap",
                 compute_dtype=torch.bfloat16, out_activation="none", fused_blocks=fused,
                 generator=torch.Generator().manual_seed(0)).to(device).eval()
    x = torch.randn((1, GLOBE_H, width, N_VARS), generator=torch.Generator().manual_seed(1))
    x = x.to(device)

    def per_forward_ms(ctx):
        """Host ms per forward after a warm-up forward (which also makes
        the halo kernel's receive buffers); for a ``TimedHaloCtx`` also the
        ms per forward spent in each of its methods."""
        fwd = spatial_apply(G, ctx)
        fwd(x)
        torch.cuda.synchronize()
        ctx.barrier()
        before = dict(getattr(ctx, "spent", {}))
        t0 = time.perf_counter()
        for _ in range(FORWARDS):
            fwd(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / FORWARDS * 1e3
        return ms, {k: (v - before[k]) / FORWARDS * 1e3
                    for k, v in getattr(ctx, "spent", {}).items()}

    with torch.inference_mode():
        ctx = HaloCtx(n, True, rdma)
        wall, _ = per_forward_ms(ctx)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fwd = spatial_apply(G, ctx)
            for _ in range(FORWARDS):
                fwd(x)
            torch.cuda.synchronize()
        ctx.close()
        timed = TimedHaloCtx(n, True, rdma)
        instrumented, spent = per_forward_ms(timed)
        timed.close()
    busy, top = _device_rows(prof, FORWARDS, TOP)
    every = [None] * n
    dist.all_gather_object(every, busy)
    return {"wall_ms": wall, "instrumented_ms": instrumented,
            **{k + "_ms": v for k, v in spent.items()},
            "rank_busy_ms": every, "top_rank0": top, "halo_route": ctx.ring.route}


def main(argv=None) -> int:
    from biasgan_tpu_torch import infer
    from biasgan_tpu_torch.parallel import placement, spawn

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="", help="write every number to this JSON file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sharded: needs a CUDA device", file=sys.stderr)
        return 2
    n = N_RANKS
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    where = placement(n, "cuda", halo_rdma=True)
    print(where)
    cards = min(n, torch.cuda.device_count())
    out = {}
    for path, (fused, rdma) in PATHS.items():
        w_multiple = infer.pad_multiples("resnet_9blocks", n)[1]
        width = -(-GLOBE_W // w_multiple) * w_multiple
        r = spawn(breakdown_rank, n, (width, fused, rdma), device="cuda", timeout=600,
                  group_timeout=300)
        r["width"] = width
        r["idle_share"] = 1 - sum(r["rank_busy_ms"]) / (cards * r["wall_ms"])
        out[path] = r
        print(f"{path} (1, {GLOBE_H}, {width}, {N_VARS}) bf16 over {n} ranks, ms per forward: "
              f"wall {r['wall_ms']:.3f}; instrumented {r['instrumented_ms']:.3f} = exchanges "
              f"{r['pad_w_ms']:.3f} + norm collectives {r['mean_w_ms'] + r['sum_w_ms']:.3f} + "
              f"gather {r['gather_w_ms']:.3f} + the rest; device busy per rank "
              f"{[round(b, 3) for b in r['rank_busy_ms']]}, the card(s) idle "
              f"{r['idle_share']:.3f} of the wall"
              + (f"; halo route {r['halo_route']}" if rdma else ""))
        for ms, calls, key in r["top_rank0"]:
            print(f"  rank 0 {ms:8.3f} ms/fwd {calls:6.1f} calls/fwd  {key}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "placement": where, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "paths": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
