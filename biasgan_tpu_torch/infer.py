"""Full-field inference CLI: apply a trained generator to whole global
grids (e.g. 721x1440 multi-channel), on one device or spatially sharded
over W (longitude) with halo exchange.

  python -m biasgan_tpu_torch.infer --model cycle_gan --dataset_mode climate \\
      --full_field --netG resnet_9blocks --norm instance --no_dropout \\
      --w_pad_mode wrap --netG_activation none --compute_dtype bfloat16 \\
      --fused_blocks --dataroot DATA --name RUN --device cuda \\
      [--spatial_mesh 4 --halo_rdma]

Counterpart of the repo-root ``infer.py``, with the same flags: read the
fields, standardize with the source-domain stats, reflect-pad H to the
2^downs multiple (a U-Net's downs, the resnets' 2) and wrap-pad W to
n_shards * 2^downs (the JAX CLI pads W x8 wider under --fused_blocks for
its TPU kernel; the padded columns enter the instance-norm statistics, so
the port, whose kernels need no alignment, does not), run G (a batch norm
normalizes by its running averages), crop, destandardize with the
target-domain stats, and write
``<results_dir>/<name>/fields/corrected_%05d.npy``. G loads from
``<checkpoints_dir>/<name>/<epoch>_net_<G>.pth``; --direction picks G_A or
G_B of a CycleGAN run.

--spatial_mesh N spawns N ranks, one process per W shard
(``parallel.mesh``): every rank reads and standardizes the field and serves
its shard, each conv exchanging its W halo with the ring neighbours and
each instance norm taking W-global statistics (``parallel.spatial``), so the
result is the whole-field forward's. Rank 0 gathers, crops, destandardizes,
times each field host to host and saves it. With a CUDA device rank r runs
on cuda:(r % device_count), over NCCL when every rank has a card of its
own, else over gloo with host copies (a notice line says which).
--halo_rdma exchanges the halos with the hand-written halo_exchange_w
kernel in place of the plain point-to-point ring: signalled on the device
where every rank has a card of its own, synchronised on the host where
ranks share one (the notice line says which; the last line, each rank's
exchanges, signalled ones and host syncs); --spatial_mesh 1
--halo_rdma is a one-rank self-ring, as in the JAX CLI (with --fused_blocks
that serves on one device, as there). --fused_blocks composes with
sharding (the block conv kernel's halo W mode); the other kernel flags
cannot engage on a sharded W and say so.

The kernel routes are the JAX CLI's flags: --fused_blocks runs the resnet
blocks through the hand-written conv3x3_fused kernel, and with it
--fused_updown the down and up convs through conv3x3s2_fused and
convt3x3s2_fused; --conv7_pallas 1 runs the 7x7 stem and head through
conv7x7; --pallas_conv 1 runs the block convs through conv3x3_valid where
--fused_blocks does not take them; --force_pallas_norm runs the remaining
instance norms through instance_norm_act. A flag that cannot engage says
why; none is silently ignored.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from biasgan_tpu_torch.config import format_config, parse_config, route_on, save_config
from biasgan_tpu_torch.data import create_dataset
from biasgan_tpu_torch.data.transforms import standardize
from biasgan_tpu_torch.kernels import launch_counts
from biasgan_tpu_torch.kernels.halo_exchange import halo_counts
from biasgan_tpu_torch.models.common import generator_of
from biasgan_tpu_torch.nn.factory import unet_downs
from biasgan_tpu_torch.nn.generators import fused_blocks_blocker
from biasgan_tpu_torch.nn.layers import conv7_eligible
from biasgan_tpu_torch.parallel import HaloCtx, pad_to_multiple, placement, spatial_apply, spawn
from biasgan_tpu_torch.registry import get_model
from biasgan_tpu_torch.utils import checkpoint


def generator_downs(netG: str) -> int:
    """Stride-product exponent of the generator (for pad divisibility): a
    U-Net's downs, or the resnets' two stride-2 downs (JAX infer.py:38-50)."""
    downs = unet_downs(netG)
    if downs is not None:
        return downs
    if netG.startswith("resnet"):
        return 2
    raise ValueError(netG)


def pad_multiples(netG: str, n_shards: int = 1) -> tuple:
    """(H, W) multiples the field is padded to before G: the 2^downs
    multiple, for W times the shards. The JAX infer.py widens the W
    multiple x8 more under --fused_blocks (infer.py:64, 112), for its TPU
    kernel's 8-aligned local width; the port's kernels mask ragged tiles,
    so it does not, and serves the field with no wrapped columns in its
    instance-norm statistics on every path."""
    h_multiple = 2 ** generator_downs(netG)
    return h_multiple, h_multiple * n_shards


def pad_field(x: torch.Tensor, h_multiple: int, w_multiple: int) -> torch.Tensor:
    """Pad NHWC ``x`` at the end of H and W up to the multiples: latitude is
    not periodic, so H reflects; longitude wraps."""
    x, _ = pad_to_multiple(x, h_multiple, axis=1, mode="reflect")
    return pad_to_multiple(x, w_multiple, axis=2, mode="wrap")[0]


def field_runner(G, h_multiple: int, w_multiple: int):
    """The per-field computation ``main`` times: standardize with the
    source stats, pad to the multiples, G, crop, destandardize with the
    target stats. Returns ``run(x, a_mean, a_std, b_mean, b_std)`` on NHWC
    ``x``. ``G`` may be a sharded forward (``spatial_apply``), which gives
    the field on rank 0 and None on the other ranks; ``run`` then does the
    same."""

    @torch.inference_mode()
    def run(x, a_mean, a_std, b_mean, b_std):
        h0, w0 = x.shape[1], x.shape[2]
        y = G(pad_field(standardize(x, a_mean, a_std), h_multiple, w_multiple))
        if y is None:
            return None
        return standardize(y[:, :h0, :w0, :], b_mean, b_std, inverse=True)

    return run


def conv7_on(value: str) -> bool:
    """--conv7_pallas: '' or '0' is off; '1' (or the JAX CPU-test value
    'interpret') is on."""
    return route_on("--conv7_pallas", value)


def load_generator(cfg, name: str, input_nc: int, output_nc: int, device: torch.device,
                   say=print) -> torch.nn.Module:
    """The run's G ``name`` (``<epoch>_net_<name>.pth``) on ``device``, on
    every kernel route of the configuration (--fused_updown too), ending in
    the model's output activation (``out_activation``: --model test ends
    in tanh whatever --netG_activation says, as the JAX TestModel)."""
    G = generator_of(cfg, input_nc, output_nc, get_model(cfg.model).out_activation(cfg),
                     fused_updown=True)
    path = checkpoint.load_network(
        G, cfg.run_dir(), checkpoint.load_tag(cfg.epoch, cfg.load_iter), name
    )
    say(f"loaded net {name} from {path}")
    return G.to(device)


def build_generator(cfg, device: torch.device) -> torch.nn.Module:
    """G of the run (--direction picks a CycleGAN run's), in eval mode on
    ``device``, with its checkpoint loaded (``load_generator``)."""
    name = get_model(cfg.model).generator_name(cfg)
    return load_generator(cfg, name, cfg.input_nc, cfg.output_nc, device).eval()


def is_sharded(cfg) -> bool:
    """Whether the run serves W shards (``serve_sharded``): --spatial_mesh
    > 1, or --halo_rdma as a one-rank self-ring unless --fused_blocks takes
    the one-device path (JAX infer.py:97)."""
    fused_ok = cfg.fused_blocks and cfg.netG.startswith("resnet")
    return cfg.spatial_mesh > 1 or (cfg.halo_rdma and not fused_ok)


def routing_notices(cfg, G: torch.nn.Module, sharded: bool = False) -> list:
    """One line for each kernel flag of ``cfg`` that cannot engage on G
    (on a sharded W with ``sharded``; G is then not read), saying why: the
    flags must never be silently ignored."""
    notes = []
    blocker = None
    if cfg.fused_blocks or cfg.fused_updown:
        if cfg.netG.startswith("resnet"):
            blocker = fused_blocks_blocker(cfg.norm, cfg.dropout())
        else:
            blocker = f"netG {cfg.netG!r} has no resnet block chain"
    if cfg.fused_blocks and blocker is not None:
        notes.append(f"--fused_blocks: ignored — {blocker}; using the plain path")
    if sharded:
        return notes + spatial_notices(cfg)
    if cfg.halo_rdma:
        notes.append("--halo_rdma: ignored — with --spatial_mesh 1 and --fused_blocks "
                     "the field is served on one device, with no exchange (as the JAX CLI)")
    if cfg.fused_updown and (blocker is not None or not cfg.fused_blocks):
        why = blocker or "it needs --fused_blocks"
        notes.append(f"--fused_updown: ignored — {why}; using cuDNN convs + norms")
    notes += pallas_conv_notices(cfg, blocker)
    resnet = cfg.netG.startswith("resnet")
    if conv7_on(cfg.conv7_pallas) and not resnet:
        notes.append(f"--conv7_pallas: ignored — netG {cfg.netG!r} has no 7x7 conv")
    elif conv7_on(cfg.conv7_pallas):
        for conv in ("stem", "head"):
            mod = getattr(G, conv)
            if not conv7_eligible(mod.weight.shape, mod.stride, mod.padding):
                cout, cin = mod.weight.shape[:2]
                notes.append(
                    f"--conv7_pallas: the {conv} ({cin} -> {cout} channels) stays "
                    "on cuDNN — the kernel takes a 7x7 conv with exactly one "
                    "channel side of at most 8"
                )
    if cfg.force_pallas_norm:
        if cfg.norm != "instance":
            notes.append(
                f"--force_pallas_norm: ignored — norm {cfg.norm!r} is not instance norm"
            )
        elif not resnet:
            notes.append(f"--force_pallas_norm: ignored — netG {cfg.netG!r} normalizes "
                         "without it, as the JAX U-Net")
        elif cfg.fused_blocks and cfg.fused_updown and blocker is None:
            notes.append(
                "--force_pallas_norm: ignored — with --fused_blocks and "
                "--fused_updown every norm rides in a conv kernel"
            )
    return notes


def spatial_notices(cfg) -> list:
    """The lines for the kernel flags that cannot engage on a sharded W
    (the JAX gates turn them off under a spatial context), and for
    --halo_rdma on the CPU, where the exchange is the kernel's plain
    version."""
    why = "it cannot engage on a sharded W (--spatial_mesh > 1 or --halo_rdma)"
    notes = []
    if cfg.fused_updown:
        notes.append(f"--fused_updown: ignored — {why}; using cuDNN convs + norms")
    if conv7_on(cfg.conv7_pallas):
        notes.append(f"--conv7_pallas: ignored — {why}; the stem and head stay on cuDNN")
    if route_on("--pallas_conv", cfg.pallas_conv):
        notes.append(f"--pallas_conv: ignored — {why}")
    if cfg.force_pallas_norm:
        notes.append(f"--force_pallas_norm: ignored — {why}; the norms take W-global "
                     "statistics")
    if cfg.halo_rdma and torch.device(cfg.device).type == "cpu":
        notes.append("--halo_rdma: on the CPU the exchange is the halo_exchange_w kernel's "
                     "plain version, the point-to-point ring")
    return notes


def pallas_conv_notices(cfg, blocker) -> list:
    """The --pallas_conv line, where it cannot engage: only the resnet's
    block convs are 3x3 stride-1 pad-1, and the fused block path takes them
    first when it engages (``blocker`` is its reason not to, or None)."""
    if not route_on("--pallas_conv", cfg.pallas_conv):
        return []
    if not cfg.netG.startswith("resnet"):
        return [f"--pallas_conv: ignored — netG {cfg.netG!r} has no 3x3 stride-1 convs"]
    if cfg.fused_blocks and blocker is None:
        return ["--pallas_conv: ignored — --fused_blocks takes the block convs"]
    return []


def serve_fields(cfg, dataset, device, run, say=print, before=lambda: None) -> str:
    """Every field of ``dataset`` through ``run`` (``field_runner``), timed
    host to host (``before`` runs just ahead of each clock start). Where
    ``run`` returns the field (one device, or rank 0 of a sharded run), its
    timing line goes to ``say`` and the field to
    ``<results_dir>/<name>/fields/``. Returns that directory."""
    # source/target field + stats pairing follows --direction
    src, tgt = ("B", "A") if cfg.direction == "BtoA" else ("A", "B")

    def stats(data, key, nc):
        if f"{key}_mean" not in data:  # single-sided datasets carry none
            return torch.zeros(nc, device=device), torch.ones(nc, device=device)
        return (
            torch.as_tensor(data[f"{key}_mean"][0], device=device),
            torch.as_tensor(data[f"{key}_std"][0], device=device),
        )

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    out_dir = os.path.join(cfg.results_dir, cfg.resolved_name(), "fields")
    os.makedirs(out_dir, exist_ok=True)
    for i, data in enumerate(dataset):
        if cfg.num_test and i >= cfg.num_test:
            break
        sk = src if src in data else "A"  # single-sided datasets yield A only
        tk = tgt if f"{tgt}_mean" in data else sk
        x = torch.as_tensor(data[sk], device=device)
        nc = x.shape[-1]
        sync()
        before()
        t0 = time.perf_counter()
        y = run(x, *stats(data, sk, nc), *stats(data, tk, nc))
        sync()
        if y is None:
            continue
        y = y.cpu().numpy()  # the field reaches the host inside the timing
        dt = time.perf_counter() - t0
        px_per_s = (y.shape[0] * y.shape[1] * y.shape[2]) / dt
        say(
            f"[{i:04d}] field {tuple(x.shape)} -> corrected in {dt*1e3:.1f} ms "
            f"({px_per_s/1e6:.1f} Mpx/s)"
        )
        np.save(os.path.join(out_dir, f"corrected_{i:05d}.npy"), y)
    return out_dir


def serve_rank(rank, n, device, say, argv):
    """One rank of ``serve_sharded`` (run by ``parallel.spawn``): the
    command line's config, G and the fields on ``device``, this rank's W
    shard of each through G with halo exchange. Returns every rank's kernel
    launches."""
    cfg = parse_config(argv, train=False)
    loading = io.StringIO()
    with contextlib.redirect_stdout(loading):
        dataset = create_dataset(cfg)
        G = build_generator(cfg, device)
    say(loading.getvalue().rstrip())
    ctx = HaloCtx(n, periodic=(cfg.w_pad_mode or "wrap") == "wrap", rdma=cfg.halo_rdma)
    run = field_runner(spatial_apply(G, ctx), *pad_multiples(cfg.netG, n))
    serve_fields(cfg, dataset, device, run, say, before=ctx.barrier)
    launches, halos = [None] * n, [None] * n
    dist.all_gather_object(launches, launch_counts())
    dist.all_gather_object(halos, halo_counts(ctx.ring))
    ctx.close()
    return {"launches": launches, "halos": halos}


def serve_sharded(cfg, argv) -> str:
    """--spatial_mesh N (or --halo_rdma): N spawned ranks serve the fields
    of command line ``argv`` (``serve_rank``); rank 0's lines are printed
    here as they come. Raises if any rank fails."""
    if (cfg.w_pad_mode or "wrap") == "reflect":
        raise NotImplementedError(
            "reflect padding on a sharded width axis is not supported; use "
            "'zero' or 'wrap' (periodic longitude)"
        )
    n = max(cfg.spatial_mesh, 1)
    print(placement(n, cfg.device, cfg.halo_rdma))
    for note in routing_notices(cfg, None, sharded=True):
        print(note)
    result = spawn(serve_rank, n, (argv,), device=cfg.device)
    print(f"spatial: kernel launches per rank {json.dumps(result['launches'])}")
    if cfg.halo_rdma:
        print(f"spatial: halo exchanges per rank {json.dumps(result['halos'])}")
    return os.path.join(cfg.results_dir, cfg.resolved_name(), "fields")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = parse_config(argv, train=False)
    print(format_config(cfg))
    save_config(cfg)
    if is_sharded(cfg):
        return serve_sharded(cfg, argv)
    device = torch.device(cfg.device)
    dataset = create_dataset(cfg)
    G = build_generator(cfg, device)

    run = field_runner(G, *pad_multiples(cfg.netG))
    for note in routing_notices(cfg, G):
        print(note)
    return serve_fields(cfg, dataset, device, run)


if __name__ == "__main__":
    main(sys.argv[1:])
