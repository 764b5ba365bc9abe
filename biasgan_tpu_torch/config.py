"""Dataclass config with per-model/per-dataset flag injection.

Counterpart of ``biasgan_tpu/config.py`` (the reference family's three-tier
argparse options), cut to the fields the ported paths read: inference
(``TestConfig``: ``infer`` and ``test``) and training (``TrainConfig``). Field names and
defaults are the JAX package's, so the same command line drives
``infer.py`` / ``train.py`` and ``python -m biasgan_tpu_torch.infer`` /
``.train``. Its two signature behaviors are kept:

* **dynamic flag injection** — after ``--model`` / ``--dataset_mode`` are
  known, the chosen plugins' extra config fields are added to the CLI;
* **reproducibility dump** — the resolved config is printed and persisted
  as JSON next to the checkpoints.

The JAX kernel-routing knobs that select a kernel the port has are carried
under their JAX names and types: ``--fused_blocks``, ``--fused_updown``,
``--conv7_pallas``, ``--pallas_conv`` and ``--force_pallas_norm`` route the
networks through the port's hand-written CUDA kernels. The others
(``--s2d_*``, ``--cin_pad``, ``--fused_min_c``, ``--convt_*``) are not: they
select XLA rewrites or TPU regime splits. ``--device`` is the port's own:
the torch device the CLIs run on (they never fall back to another).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, fields
from typing import List, Optional


@dataclass
class BaseConfig:
    # experiment
    dataroot: str = ""
    name: str = "experiment"
    checkpoints_dir: str = "./checkpoints"
    seed: int = 0
    suffix: str = ""
    verbose: bool = False
    phase: str = "train"
    # model selection (reference --model/--netG/...)
    model: str = "pix2pix"
    netG: str = "unet_256"
    netD: str = "basic"
    ngf: int = 64
    ndf: int = 64
    n_layers_D: int = 3
    norm: str = "batch"
    init_type: str = "normal"
    init_gain: float = 0.02
    no_dropout: bool = False
    input_nc: int = 3
    output_nc: int = 3
    direction: str = "AtoB"
    # data
    dataset_mode: str = "aligned"
    batch_size: int = 1
    load_size: int = 286
    crop_size: int = 256
    max_dataset_size: int = -1  # -1 = unlimited (reference: inf)
    preprocess: str = "resize_and_crop"
    no_flip: bool = False
    serial_batches: bool = False
    # reader threads of the loader: a producer thread over a pool of this
    # many workers keeps 2 batches ahead of the step (the batches are those
    # of 0, which reads in the consumer's thread; the test time default)
    num_threads: int = 4
    # checkpoint selection
    epoch: str = "latest"
    load_iter: int = 0
    # compute dtype of the convs: 'float32' | 'bfloat16'
    compute_dtype: str = "float32"
    # width-axis (longitude) sharding over this many ranks, one process each,
    # for inference and training (1 = single device); --halo_rdma exchanges
    # the halos with the halo_exchange_w kernel (inference only)
    spatial_mesh: int = 1
    halo_rdma: bool = False
    # periodic-longitude padding for global fields ('' = architecture default)
    w_pad_mode: str = ""
    # in-step augmentation (climate/synthetic data): random W flip, and the
    # periodic longitude roll
    in_graph_aug: bool = False
    aug_lon_roll: bool = False
    # generator output activation: 'tanh' (images) | 'none' (standardized fields)
    netG_activation: str = "tanh"
    # route the resnet-block chain through the hand-written conv3x3_fused
    # kernel (kernels/conv3x3_fused.py): SAME pad in-kernel, instance-norm
    # prologue, output moments; in training conv3x3_fused_t, the kernel with
    # its exact backward. Needs instance norm and no dropout.
    fused_blocks: bool = False
    # with --fused_blocks engaged, in inference: the two stride-2 down convs
    # and the two up conv-transposes through the conv3x3s2_fused /
    # convt3x3s2_fused kernels, each norm riding into the next conv as its
    # prologue
    fused_updown: bool = False
    # '' | '0' = off, '1' (or 'interpret', the JAX CPU-test value) = every
    # 3x3 stride-1 pad-1 conv through the conv3x3_valid kernel, and in
    # training its input gradient too (conv3x3_op)
    pallas_conv: str = ""
    # '' | '0' = off, '1' (or 'interpret', the JAX CPU-test value) = the 7x7
    # stem and head through the conv7x7 kernel
    conv7_pallas: str = ""
    # every instance norm + [residual] + activation through the
    # instance_norm_act kernel
    force_pallas_norm: bool = False
    # torch device to run on ('cuda', 'cuda:1', 'cpu')
    device: str = "cuda"

    def resolved_name(self) -> str:
        if self.suffix:
            return f"{self.name}_{self.suffix.format(**dataclasses.asdict(self))}"
        return self.name

    def run_dir(self) -> str:
        return os.path.join(self.checkpoints_dir, self.resolved_name())

    def dropout(self) -> bool:
        return not self.no_dropout


@dataclass
class TrainConfig(BaseConfig):
    # schedule lengths (reference --n_epochs / --n_epochs_decay)
    n_epochs: int = 100
    n_epochs_decay: int = 100
    epoch_count: int = 1
    # optimization
    lr: float = 2e-4
    beta1: float = 0.5
    # Adam first-moment storage dtype: 'float32' | 'bfloat16' (the second
    # moment stays f32; optax scale_by_adam(mu_dtype=...)'s arithmetic)
    adam_mu_dtype: str = "float32"
    gan_mode: str = "lsgan"
    pool_size: int = 50
    lr_policy: str = "linear"  # linear | step | plateau | cosine
    lr_decay_iters: int = 50
    continue_train: bool = False
    # logging / checkpoint cadence
    print_freq: int = 100
    save_latest_freq: int = 5000
    save_epoch_freq: int = 5
    save_by_iter: bool = False
    # dataset-size dependent; set by train.py for the LR schedules
    steps_per_epoch: int = 0
    # data-parallel ranks, one process each (1 = single device); each steps
    # on its slice of every global batch of --batch_size
    data_mesh: int = 1
    # K optimization steps per call: K batches stacked (K, B, ...) and
    # copied to the device once, the step run K times with no host read
    # between; the cadences count in K-step chunks and each epoch's ragged
    # tail of fewer than K batches is dropped. 1 = a step per call
    steps_per_call: int = 1
    # the validation metric bundle (rmse, bias, pdf_tv, log-spectral
    # distance) every --val_freq samples; 0 = off
    val_freq: int = 0
    # hold out the last N samples of the dataset as the validation split:
    # the held-out bundles and the plateau LR metric are computed on them in
    # eval mode; 0 = no split (climate and image data may bring a 'val'
    # phase instead)
    val_split: int = 0
    # HTML snapshot pages of the step's visuals every N samples (global),
    # <run_dir>/web/index.html
    display_freq: int = 400
    # a torch.profiler trace of steps 10-20 of the first epoch into
    # <run_dir>/profile
    profile: bool = False
    # every N optimization steps, raise FloatingPointError naming the
    # offending loss key if any loss is NaN/Inf (and every 10th check sweep
    # every net's parameters). 0 = off
    check_finite: int = 0
    # debugging runs: torch.autograd.set_detect_anomaly(True) for the run,
    # which names the backward op that made the first NaN (the counterpart
    # of jax_debug_nans); orders slower. Use --check_finite for guarding
    debug_nans: bool = False


@dataclass
class TestConfig(BaseConfig):
    results_dir: str = "./results"
    # the result images' H / W ratio: > 1 stretches H, < 1 stretches W
    # (bicubic)
    aspect_ratio: float = 1.0
    num_test: int = 50
    # the test forward in eval mode (running averages, no dropout); the
    # reference's default is a training-mode forward (batch statistics,
    # test-time dropout) that moves no running average
    eval: bool = False
    phase: str = "test"
    # test-time loader defaults (reference TestOptions hardcodes these)
    batch_size: int = 1
    load_size: int = 256  # reference parity: load_size = crop_size at test
    serial_batches: bool = True
    no_flip: bool = True
    num_threads: int = 0


def mesh_of(cfg) -> tuple:
    """(data ranks, spatial ranks) of a training config: --data_mesh D and
    --spatial_mesh S, both above 1 being the 2-D mesh of D x S ranks.
    Raises where the global --batch_size does not split evenly over the
    data ranks, and where the crop's W does not split over S shards of
    the generator's 2^downs (each shard must halve at every down)."""
    from biasgan_tpu_torch.nn.factory import generator_downs

    data, spatial = max(cfg.data_mesh, 1), max(cfg.spatial_mesh, 1)
    if cfg.batch_size % data:
        raise ValueError(f"--batch_size {cfg.batch_size} (the global batch) does not split "
                         f"evenly over --data_mesh {data} ranks")
    if spatial > 1:
        unit = spatial * 2 ** generator_downs(cfg.netG)
        if cfg.crop_size % unit:
            raise ValueError(
                f"--crop_size {cfg.crop_size} (the field's W) does not split over "
                f"--spatial_mesh {spatial} shards of netG {cfg.netG!r}: W must be a multiple "
                f"of {spatial} x 2^{generator_downs(cfg.netG)} = {unit}")
    return data, spatial


ROUTE_VALUES = ("", "0", "1", "interpret")


def route_on(flag: str, value: str) -> bool:
    """A string kernel-route flag (--conv7_pallas, --pallas_conv): '' or '0'
    is off; '1' (or the JAX CPU-test value 'interpret') is on."""
    if value not in ROUTE_VALUES:
        raise ValueError(f"{flag} {value!r}: expected one of {ROUTE_VALUES}")
    return value not in ("", "0")


# ---------------------------------------------------------------------------
# dataclass -> argparse
# ---------------------------------------------------------------------------


def _add_dataclass_args(parser: argparse.ArgumentParser, cls, seen: set) -> None:
    for f in fields(cls):
        if f.name in seen:
            continue
        seen.add(f.name)
        default = f.default if f.default is not dataclasses.MISSING else None
        arg = "--" + f.name
        if f.type in (bool, "bool"):
            parser.add_argument(arg, action=argparse.BooleanOptionalAction, default=default)
        elif f.type in (int, "int"):
            parser.add_argument(arg, type=int, default=default)
        elif f.type in (float, "float"):
            parser.add_argument(arg, type=float, default=default)
        else:
            parser.add_argument(arg, type=str, default=default)


def parse_config(argv: Optional[List[str]] = None, train: bool = False):
    """Two-phase parse mirroring the reference's ``gather_options``:
    1) parse --model/--dataset_mode with defaults,
    2) merge the plugin config dataclasses (their fields become CLI flags and
       their field defaults override the base defaults),
    3) final parse, build the merged config object.

    ``train`` selects ``TrainConfig``, else ``TestConfig``.
    """
    from biasgan_tpu_torch import registry

    base_cls = TrainConfig if train else TestConfig
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", type=str, default=base_cls().model)
    pre.add_argument("--dataset_mode", type=str, default=None)
    known, _ = pre.parse_known_args(argv)

    model_cls = registry.get_model(known.model)
    model_cfg_cls = registry.get_model_config(known.model)
    extra_cfgs = [c for c in [model_cfg_cls] if c is not None]

    # model may force a different default dataset_mode
    model_defaults = getattr(model_cls, "config_defaults", lambda train: {})(train)
    dataset_mode = known.dataset_mode or model_defaults.get(
        "dataset_mode", base_cls().dataset_mode
    )
    ds_cls = registry.get_dataset(dataset_mode)
    ds_cfg_cls = registry.get_dataset_config(dataset_mode)
    if ds_cfg_cls is not None:
        extra_cfgs.append(ds_cfg_cls)
    ds_defaults = getattr(ds_cls, "config_defaults", lambda train: {})(train)

    parser = argparse.ArgumentParser(
        description="biasgan_tpu_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    seen: set = set()
    _add_dataclass_args(parser, base_cls, seen)
    for c in extra_cfgs:
        _add_dataclass_args(parser, c, seen)

    # apply model/dataset-declared defaults (reference modify_commandline_options)
    defaults = dict(ds_defaults)
    defaults.update(model_defaults)
    defaults["dataset_mode"] = dataset_mode
    parser.set_defaults(**{k: v for k, v in defaults.items() if k in seen})
    ns = parser.parse_args(argv)

    cfg_cls = merge_config_cls(base_cls, *extra_cfgs)
    valid = {f.name for f in fields(cfg_cls)}
    return cfg_cls(**{k: v for k, v in vars(ns).items() if k in valid})


_MERGED_CACHE = {}


def merge_config_cls(base_cls, *extras):
    """Create (and cache) a dataclass combining base + plugin config fields."""
    key = (base_cls,) + tuple(extras)
    if key in _MERGED_CACHE:
        return _MERGED_CACHE[key]
    cls = base_cls
    for extra in extras:
        new_fields = [
            (f.name, f.type, f)
            for f in fields(extra)
            if f.name not in {g.name for g in fields(cls)}
        ]
        cls = dataclasses.make_dataclass(
            f"{cls.__name__}_{extra.__name__}", new_fields, bases=(cls,)
        )
    _MERGED_CACHE[key] = cls
    return cls


def save_config(cfg, path: Optional[str] = None) -> str:
    """Persist the resolved config (reference: opt.txt) as JSON."""
    run_dir = cfg.run_dir()
    os.makedirs(run_dir, exist_ok=True)
    path = path or os.path.join(run_dir, f"{cfg.phase}_config.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, sort_keys=True)
    return path


def format_config(cfg) -> str:
    lines = ["----------------- Config ---------------"]
    for k, v in sorted(dataclasses.asdict(cfg).items()):
        lines.append(f"{k}: {v}")
    lines.append("----------------- End -------------------")
    return "\n".join(lines)
