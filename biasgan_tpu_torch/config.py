"""Dataclass config with per-model/per-dataset flag injection.

Counterpart of ``biasgan_tpu/config.py`` (the reference family's three-tier
argparse options), cut to the fields the inference slice reads. Field names
and defaults are the JAX package's, so the same command line drives both
``infer.py`` and ``python -m biasgan_tpu_torch.infer``. Its two signature
behaviors are kept:

* **dynamic flag injection** — after ``--model`` / ``--dataset_mode`` are
  known, the chosen plugins' extra config fields are added to the CLI;
* **reproducibility dump** — the resolved config is printed and persisted
  as JSON next to the checkpoints.

The JAX kernel-routing knobs that select a kernel the port has are carried
under their JAX names and types: ``--fused_blocks``, ``--fused_updown``,
``--conv7_pallas`` and ``--force_pallas_norm`` route the resnet generator
through the port's hand-written CUDA kernels. The others (``--pallas_conv``,
``--s2d_*``, ``--cin_pad``, ``--fused_min_c`` and the rest) are not: they
select XLA rewrites or TPU regime splits, or a kernel not ported yet.
``--device`` is the port's own: the torch device the inference CLI runs on
(it never falls back to another).
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
    ngf: int = 64
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
    crop_size: int = 256
    max_dataset_size: int = -1  # -1 = unlimited (reference: inf)
    preprocess: str = "resize_and_crop"
    serial_batches: bool = False
    # checkpoint selection
    epoch: str = "latest"
    load_iter: int = 0
    # compute dtype of the convs: 'float32' | 'bfloat16'
    compute_dtype: str = "float32"
    # width-axis sharding for full-globe inference (1 = single device)
    spatial_mesh: int = 1
    halo_rdma: bool = False
    # periodic-longitude padding for global fields ('' = architecture default)
    w_pad_mode: str = ""
    # generator output activation: 'tanh' (images) | 'none' (standardized fields)
    netG_activation: str = "tanh"
    # route the resnet-block chain through the hand-written conv3x3_fused
    # kernel (kernels/conv3x3_fused.py): SAME pad in-kernel, instance-norm
    # prologue, output moments. Needs instance norm, no dropout, eval mode.
    fused_blocks: bool = False
    # with --fused_blocks engaged: the two stride-2 down convs and the two
    # up conv-transposes through the conv3x3s2_fused / convt3x3s2_fused
    # kernels, each norm riding into the next conv as its prologue
    fused_updown: bool = False
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
class TestConfig(BaseConfig):
    results_dir: str = "./results"
    num_test: int = 50
    phase: str = "test"
    # test-time loader defaults (reference TestOptions hardcodes these)
    batch_size: int = 1
    serial_batches: bool = True


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

    Only the test-time options exist so far; the training options arrive
    with the training slice of the port.
    """
    if train:
        raise NotImplementedError(
            "training options are not ported yet (the pix2pix training "
            "slice adds TrainConfig)"
        )
    from biasgan_tpu_torch import registry

    base_cls = TestConfig
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
