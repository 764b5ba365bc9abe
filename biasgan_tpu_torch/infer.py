"""Full-field inference CLI: apply a trained generator to whole global
grids (e.g. 721x1440 multi-channel) on one device.

  python -m biasgan_tpu_torch.infer --model cycle_gan --dataset_mode climate \\
      --full_field --netG resnet_9blocks --norm instance --no_dropout \\
      --w_pad_mode wrap --netG_activation none --compute_dtype bfloat16 \\
      --fused_blocks --dataroot DATA --name RUN --device cuda

Counterpart of the repo-root ``infer.py``, with the same flags, for one
device: read the fields, standardize with the source-domain stats,
reflect-pad H to the 2^downs multiple and wrap-pad W to the multiple
``infer.py`` uses (x8 more under --fused_blocks; the padded columns enter
the instance-norm statistics, so the multiple changes the output), run G,
crop, destandardize with the target-domain stats, and write
``<results_dir>/<name>/fields/corrected_%05d.npy``. G loads from
``<checkpoints_dir>/<name>/<epoch>_net_<G>.pth``; --direction picks G_A or
G_B of a CycleGAN run.

--fused_blocks runs the resnet blocks through the hand-written
conv3x3_fused kernel. Spatial sharding over several devices
(--spatial_mesh > 1, --halo_rdma) is not ported yet.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from biasgan_tpu_torch.config import format_config, parse_config, save_config
from biasgan_tpu_torch.data import create_dataset
from biasgan_tpu_torch.data.transforms import standardize
from biasgan_tpu_torch.nn import compute_dtype_of, define_G
from biasgan_tpu_torch.nn.generators import fused_blocks_blocker
from biasgan_tpu_torch.ops.padding import pad_hw
from biasgan_tpu_torch.registry import get_model
from biasgan_tpu_torch.utils import checkpoint


def generator_downs(netG: str) -> int:
    """Stride-product exponent of the generator (for pad divisibility);
    the ported generators are the resnets, with two stride-2 downs."""
    if netG.startswith("resnet"):
        return 2
    raise ValueError(netG)


def _pad_up(size: int, multiple: int) -> int:
    return -(-size // multiple) * multiple - size


def pad_multiples(netG: str, fused_blocks: bool) -> tuple:
    """(H, W) multiples the field is padded to before G: the 2^downs
    multiple, and for W x8 more when --fused_blocks is asked for a resnet
    (the JAX infer.py widens the wrap pad so whenever the fused path is
    requested, infer.py:112; the padded columns enter the instance-norm
    statistics, so the port widens the same way)."""
    h_multiple = 2 ** generator_downs(netG)
    w_multiple = h_multiple * (8 if fused_blocks and netG.startswith("resnet") else 1)
    return h_multiple, w_multiple


def pad_field(x: torch.Tensor, h_multiple: int, w_multiple: int) -> torch.Tensor:
    """Pad NHWC ``x`` at the end of H and W up to the multiples: latitude is
    not periodic, so H reflects; longitude wraps."""
    return pad_hw(
        x, (0, _pad_up(x.shape[1], h_multiple)), (0, _pad_up(x.shape[2], w_multiple)),
        "reflect", "wrap",
    )


def field_runner(G: torch.nn.Module, h_multiple: int, w_multiple: int):
    """The per-field computation ``main`` times: standardize with the
    source stats, pad to the multiples, G, crop, destandardize with the
    target stats. Returns ``run(x, a_mean, a_std, b_mean, b_std)`` on NHWC
    ``x``."""

    @torch.inference_mode()
    def run(x, a_mean, a_std, b_mean, b_std):
        h0, w0 = x.shape[1], x.shape[2]
        x = pad_field(standardize(x, a_mean, a_std), h_multiple, w_multiple)
        y = G(x)[:, :h0, :w0, :]
        return standardize(y, b_mean, b_std, inverse=True)

    return run


def build_generator(cfg, device: torch.device) -> torch.nn.Module:
    """G of the run, in eval mode on ``device``, with its checkpoint loaded."""
    G = define_G(
        cfg.netG,
        input_nc=cfg.input_nc,
        output_nc=cfg.output_nc,
        ngf=cfg.ngf,
        norm=cfg.norm,
        use_dropout=cfg.dropout(),
        init_type=cfg.init_type,
        init_gain=cfg.init_gain,
        w_mode=cfg.w_pad_mode or None,
        compute_dtype=compute_dtype_of(cfg.compute_dtype),
        out_activation=cfg.netG_activation,
        fused_blocks=cfg.fused_blocks,
    )
    name = get_model(cfg.model).generator_name(cfg)
    path = checkpoint.load_network(
        G, cfg.run_dir(), checkpoint.load_tag(cfg.epoch, cfg.load_iter), name
    )
    print(f"loaded net {name} from {path}")
    return G.to(device).eval()


def main(argv=None):
    cfg = parse_config(argv, train=False)
    if cfg.spatial_mesh > 1 or cfg.halo_rdma:
        raise NotImplementedError(
            "--spatial_mesh > 1 / --halo_rdma: spatially sharded inference is "
            "not ported yet (it arrives with the port's parallel/ slice); "
            "run with --spatial_mesh 1"
        )
    print(format_config(cfg))
    save_config(cfg)
    device = torch.device(cfg.device)
    dataset = create_dataset(cfg)
    G = build_generator(cfg, device)

    run = field_runner(G, *pad_multiples(cfg.netG, cfg.fused_blocks))
    if cfg.fused_blocks:
        if cfg.netG.startswith("resnet"):
            blocker = fused_blocks_blocker(cfg.norm, cfg.dropout(), G.training)
        else:
            blocker = f"netG {cfg.netG!r} has no resnet block chain"
        if blocker is not None:
            # the flag must never be silently ignored
            print(f"--fused_blocks: ignored — {blocker}; using the plain path")

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
        t0 = time.perf_counter()
        y = run(x, *stats(data, sk, nc), *stats(data, tk, nc))
        sync()
        y = y.cpu().numpy()  # the field reaches the host inside the timing
        dt = time.perf_counter() - t0
        px_per_s = (y.shape[0] * y.shape[1] * y.shape[2]) / dt
        print(
            f"[{i:04d}] field {tuple(x.shape)} -> corrected in {dt*1e3:.1f} ms "
            f"({px_per_s/1e6:.1f} Mpx/s)"
        )
        np.save(os.path.join(out_dir, f"corrected_{i:05d}.npy"), y)
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1:])
