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

The kernel routes are the JAX CLI's flags: --fused_blocks runs the resnet
blocks through the hand-written conv3x3_fused kernel, and with it
--fused_updown the down and up convs through conv3x3s2_fused and
convt3x3s2_fused; --conv7_pallas 1 runs the 7x7 stem and head through
conv7x7; --force_pallas_norm runs the remaining instance norms through
instance_norm_act. A flag that cannot engage says why; none is silently
ignored. Spatial sharding over several devices (--spatial_mesh > 1,
--halo_rdma) is not ported yet.
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
from biasgan_tpu_torch.nn.layers import conv7_eligible
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


CONV7_VALUES = ("", "0", "1", "interpret")


def conv7_on(value: str) -> bool:
    """--conv7_pallas: '' or '0' is off; '1' (or the JAX CPU-test value
    'interpret') is on."""
    if value not in CONV7_VALUES:
        raise ValueError(f"--conv7_pallas {value!r}: expected one of {CONV7_VALUES}")
    return value not in ("", "0")


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
        fused_updown=cfg.fused_updown,
        conv7=conv7_on(cfg.conv7_pallas),
        fused_norm=cfg.force_pallas_norm,
    )
    name = get_model(cfg.model).generator_name(cfg)
    path = checkpoint.load_network(
        G, cfg.run_dir(), checkpoint.load_tag(cfg.epoch, cfg.load_iter), name
    )
    print(f"loaded net {name} from {path}")
    return G.to(device).eval()


def routing_notices(cfg, G: torch.nn.Module) -> list:
    """One line for each kernel flag of ``cfg`` that cannot engage on G,
    saying why: the flags must never be silently ignored."""
    notes = []
    blocker = None
    if cfg.fused_blocks or cfg.fused_updown:
        if cfg.netG.startswith("resnet"):
            blocker = fused_blocks_blocker(cfg.norm, cfg.dropout(), G.training)
        else:
            blocker = f"netG {cfg.netG!r} has no resnet block chain"
    if cfg.fused_blocks and blocker is not None:
        notes.append(f"--fused_blocks: ignored — {blocker}; using the plain path")
    if cfg.fused_updown and (blocker is not None or not cfg.fused_blocks):
        why = blocker or "it needs --fused_blocks"
        notes.append(f"--fused_updown: ignored — {why}; using cuDNN convs + norms")
    if conv7_on(cfg.conv7_pallas):
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
        elif cfg.fused_blocks and cfg.fused_updown and blocker is None:
            notes.append(
                "--force_pallas_norm: ignored — with --fused_blocks and "
                "--fused_updown every norm rides in a conv kernel"
            )
    return notes


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
    for note in routing_notices(cfg, G):
        print(note)

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
