"""Cells of the bench cut to sizes a CPU test can hold: the networks' widths
and depths, the fields and batches, for the tests' runs of the harness on
the CPU (the program takes its kernels' plain versions there)."""

from __future__ import annotations

import time

import torch

from portbench import harness

SEED = 2**31 + 4242
# the bench's cells, by kind
SERVE = "cyclegan_resnet9.globe_serve_b2"
CYCLE = "cyclegan_resnet9.train_b32"
TRAIN = ["pix2pix_unet256.train_b128", CYCLE]


def tiny_cell(name: str) -> dict:
    cell = harness.load_cell(name)
    cfg, mix = cell["cfg"], cell["mix"]
    cfg.update(ngf=8, ndf=8)
    if cfg["netG"].startswith("resnet"):
        cfg.update(netG="resnet_2blocks", n_blocks=2)
    else:
        cfg.update(netG="unet_64", unet_downs=6)
    if mix["kind"] == "serve":
        mix.update(field=[21, 40], batch=2, pool=4, warmup=1, sample=3, trace_calls=2,
                   trace_labelled=1)
    else:
        mix.update(batch=4 if cfg["model"] == "pix2pix" else 2, crop=64, pool=2,
                   warmup_calls=2, trace_calls=2, trace_labelled=1)
    return cell


def driver(cell):
    import importlib

    return importlib.import_module("portbench.drivers." + cell["mix"]["kind"])


def run(cell, fault=None, trace=False, seed=SEED, seconds=0.05) -> dict:
    torch.manual_seed(0)
    return driver(cell).run(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), fault=fault)
