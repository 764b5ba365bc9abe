"""The ``serve`` traffic kind: whole fields through the program's served
path, ``batch`` fields a call, one call after another in a closed loop.

Set-up builds the generator as the program's inference CLI builds it
(``config.parse_config`` of the configuration's and the cell's route
flags, ``models.common.generator_of``), loads the seeded weights, draws a
pool of distinct fields and their per-variable statistics on the card, and
serves ``warmup`` calls. Each call of the window is the program's
``infer.field_runner`` (standardize, pad, G, crop, destandardize) on a
batch of fields and the copy of the corrected batch to the host, as
``infer.serve_fields`` serves and times a batch of its loader; no field is
written to disk. Calls cycle through the pool, each on distinct fields.

The check: a sample of the window's fields, drawn from the seed by
reservoir, each held against the plain reference of ``reference/`` on the
same input and statistics, in f32 with TF32 off, after the window has
closed and the program is freed. Per variable, the gap is measured in
units of the reference's own spread about the target mean:
``field_rel_rms`` is the largest RMS gap, ``field_max_gap`` the largest
single gap, over the sampled fields and variables.
"""

from __future__ import annotations

import random
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import harness
from portbench.reference import nets


def program_args(cell, device) -> List[str]:
    cfg, serve = cell["cfg"], cell["cfg"]["serve"]
    args = ["--model", cfg["model"], "--netG", cfg["netG"], "--ngf", str(cfg["ngf"]),
            "--norm", cfg["norm"], "--input_nc", str(cfg["input_nc"]),
            "--output_nc", str(cfg["output_nc"]), "--compute_dtype", cfg["compute_dtype"],
            "--w_pad_mode", serve["w_pad_mode"], "--netG_activation", serve["netG_activation"],
            "--device", device.type]
    return args + ([] if cfg["dropout"] else ["--no_dropout"]) + list(cell["route"])


def spec_of(cfg) -> list:
    return nets.resnet_spec(cfg["input_nc"], cfg["output_nc"], cfg["ngf"], cfg["n_blocks"])


def make_fields(cell, seed: int, device):
    """The pool of distinct input fields (P, H, W, C) and the statistics
    (a_mean, a_std, b_mean, b_std), each (C,), drawn on ``device``."""
    mix, c = cell["mix"], cell["cfg"]["input_nc"]
    h, w = mix["field"]
    g = torch.Generator(device=device).manual_seed(harness.derive(seed, "fields"))
    mean = torch.randn(2, c, generator=g, device=device) * 10.0
    std = 0.5 + 4.5 * torch.rand(2, c, generator=g, device=device)
    pool = torch.randn((mix["pool"], h, w, c), generator=g, device=device)
    pool = pool * std[0] + mean[0]
    return pool, (mean[0], std[0], mean[1], std[1])


def pad_end(x, axis: int, multiple: int, mode: str):
    """Pad NHWC ``x`` at the end of ``axis`` up to the multiple (reflect:
    the rows before the last, last first; wrap: the first rows)."""
    n = x.shape[axis]
    extra = -(-n // multiple) * multiple - n
    if extra == 0:
        return x
    idx = (list(range(n - 2, n - 2 - extra, -1)) if mode == "reflect"
           else [i % n for i in range(n, n + extra)])
    return torch.cat([x, x.index_select(axis, torch.tensor(idx, device=x.device))], axis)


@torch.no_grad()
def reference_field(cfg, P, x, stats, quant=None) -> torch.Tensor:
    """The corrected field by the plain reference: standardize with the
    source statistics, pad H (reflect) and W (wrap) at their ends to
    multiples of 4, G, crop, destandardize with the target statistics."""
    a_mean, a_std, b_mean, b_std = stats
    h0, w0 = x.shape[1], x.shape[2]
    z = pad_end(pad_end((x - a_mean) / a_std, 1, 4, "reflect"), 2, 4, "wrap")
    y = nets.resnet_g(P, z, cfg["n_blocks"], cfg["serve"]["w_pad_mode"],
                      cfg["serve"]["netG_activation"], quant)[:, :h0, :w0]
    return y * b_std + b_mean


def field_numbers(prog: np.ndarray, ref: torch.Tensor, b_mean) -> Dict[str, float]:
    """Per variable, the RMS and the largest gap of ``prog`` from ``ref``
    over the RMS of ``ref`` about the target mean; the largest of each."""
    p = torch.from_numpy(np.asarray(prog)).to(ref.device, torch.float64)
    r = ref.double()
    err = (p - r).reshape(-1, r.shape[-1])
    scale = (r - b_mean.double()).reshape(-1, r.shape[-1]).square().mean(0).sqrt()
    rel_rms = (err.square().mean(0).sqrt() / scale).max()
    max_gap = (err.abs().amax(0) / scale).max()
    return {"field_rel_rms": float(rel_rms), "field_max_gap": float(max_gap)}


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def build(cell, device, params):
    from biasgan_tpu_torch import infer
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.models.common import generator_of

    pcfg = parse_config(program_args(cell, device), train=False)
    G = generator_of(pcfg, pcfg.input_nc, pcfg.output_nc, fused_updown=True).to(device).eval()
    harness.load_into(G, params, "G")
    for note in infer.routing_notices(pcfg, G):
        print(note, file=sys.stderr)
    return G, infer.field_runner(G, *infer.pad_multiples(pcfg.netG))


def serve(run, pool, stats, batch: int, n: Optional[int], seconds: float, sample: Reservoir,
          fault: Optional[str], sync, runner_ms: Optional[list] = None) -> Tuple[int, float]:
    """Serve calls of ``batch`` fields until ``n`` calls are done or
    ``seconds`` have passed; returns (fields, window seconds). Each call's
    host ms in ``run``, until it returns, is appended to ``runner_ms``."""
    rf = torch.autograd.profiler.record_function
    calls, t_start = 0, time.perf_counter()
    while True:
        first = calls * batch % pool.shape[0]
        x = pool[first:first + batch]
        with rf(harness.SPAN + "serve.call"):
            sync()
            with rf(harness.SPAN + "serve.field_runner"):
                t_run = time.perf_counter()
                y = run(x, *stats)
                if runner_ms is not None:
                    runner_ms.append((time.perf_counter() - t_run) * 1e3)
            if fault == "answer":  # a corrected value altered where it is made
                y = y.clone()
                y[:, :16, :16, 0] += stats[3][0]
            with rf(harness.SPAN + "serve.sync"):
                sync()
            with rf(harness.SPAN + "serve.copy_to_host"):
                y = y.cpu().numpy()
        for k in range(batch):
            sample.offer((first + k, y[k:k + 1]))
        calls += 1
        elapsed = time.perf_counter() - t_start
        if (n is not None and calls >= n) or (n is None and elapsed >= seconds):
            return calls * batch, elapsed


def check(cell, seed, device, pool, stats, sample: Reservoir) -> List[Dict[str, float]]:
    """Each sampled field's numbers against the plain reference (module
    docstring)."""
    cfg = cell["cfg"]
    harness.exact_f32()
    P = harness.make_params({"G": spec_of(cfg)}, seed, device)["G"]
    refs, out = {}, []
    for idx, y in sample.items:
        if idx not in refs:
            refs[idx] = reference_field(cfg, P, pool[idx].unsqueeze(0), stats)
        out.append(field_numbers(y, refs[idx], stats[2]))
    return out


def worst(per_field: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(f[k] for f in per_field) for k in per_field[0]}


def run(cell, seed: int, seconds: float, trace: bool, device, t_origin: float,
        fault: Optional[str] = None) -> dict:
    mix = cell["mix"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    params = harness.make_params({"G": spec_of(cell["cfg"])}, seed, device)["G"]
    G, runner = build(cell, device, params)
    if fault == "control":  # the reference in fp8, in the program's place
        from portbench.reference.steps import fp8_quant

        def runner(x, *stats, P=params):
            return reference_field(cell["cfg"], P, x, stats, fp8_quant)
    else:
        del params
    pool, stats = make_fields(cell, seed, device)
    warm = Reservoir(0, 0)
    serve(runner, pool, stats, mix["batch"], mix["warmup"], 0.0, warm, None, sync)
    sync()
    setup_s = time.perf_counter() - t_origin
    sample = Reservoir(mix["sample"], harness.derive(seed, "sample"))
    reading = None
    if trace:
        runner_ms = []
        reading = harness.traced(
            cell,
            lambda: serve(runner, pool, stats, mix["batch"], mix["trace_calls"], 0.0, sample,
                          fault, sync, runner_ms),
            lambda: serve(runner, pool, stats, mix["batch"], mix["trace_labelled"], 0.0,
                          Reservoir(0, 0), fault, sync),
            {"field": tuple(pool.shape[1:3]), "batch": mix["batch"], "runner_ms": runner_ms})
        fields, window = reading.trace.units, reading.trace.window_s
    else:
        fields, window = serve(runner, pool, stats, mix["batch"], None, seconds, sample, fault,
                               sync)
    device_info = harness.device_block(device, cell["chips"])
    del G, runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    per_field = check(cell, seed, device, pool, stats, sample)
    found = worst(per_field)
    ok, checks = harness.judge(found, cell["limits"])
    failed = sum(not harness.judge(f, cell["limits"])[0] for f in per_field)
    print(f"portbench: the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    metrics = {"setup_s": {"value": setup_s, "unit": "s"},
               cell["rate"]: {"value": fields / window, "unit": "fields/s"}}
    return {"correct": ok, "attempted": fields, "failed": failed, "metrics": metrics,
            "device": device_info, "reading": reading, "checks": checks, "numbers": found}
