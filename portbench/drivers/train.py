"""The ``train`` traffic kind: the program's training call, back to back.

Set-up builds the training state as the program's training CLI does
(``config.parse_config`` of the configuration's and the cell's route
flags, the model's ``build_nets`` and ``create_state``), loads the seeded
weights, draws a pool of distinct input stacks on the card, and builds the
call the CLI builds, ``models.common.make_scan_step(make_train_step(cfg),
K, seed)``. It drives that state and call through ``warmup_calls`` calls:
the first steps, which the check reads, then the window continues the same
state through the same call, cycling through the pool. The window is timed
on the host from its first call to the synchronize after its last.

The check: the program's readings from its first steps are each step's
losses, the first gradient of every leaf as Adam got it (worked out from
the first moment after step 1, ``mu / (1 - b1)``) and each leaf's change
after step 3 (batch norm's running averages included); the plain
reference of ``reference/`` steps three times from the same weights and
inputs, in f32 with TF32 off, after the window has closed and the program
is freed. The numbers, per optimizer (its G and its D leaves); a cell
compares those its limits name:

* ``loss_gap`` (``loss1_gap``): the largest relative gap of a loss over the
  three steps (over step 1);
* ``grad_gap`` (``grad_gap_median``): the worst (the median) leaf's gap of
  first-gradient norms, over the larger of that leaf's and the median
  leaf's reference norm;
* ``change_gap`` (``change_gap_median``): the same of the change after
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a bias in front of a norm has none, and
  moves under Adam by round-off alone);
* ``grad_diff`` (``grad_diff_median``): as ``grad_gap``, of the norm of
  each leaf's difference from the reference in place of the gap of the two
  norms, which a gradient wrong in direction, or noisy, but of the right
  size would pass;
* ``fake_rel_rms``: the first step's generated batches (``fake_B``, and
  CycleGAN's ``fake_A``), their RMS gap over the reference's RMS: the norms
  above are blind to rounding noise, which this is not.

The later steps' losses and the worst leaf's change swing with rounding
(Adam's first steps are sign-like), and a one-element leaf's gradient is
one bf16 reduction: where those swing, a cell compares the steady forms.
The difference holds bf16's rounding of every product, which the gap of
two norms averages away: a cell compares it only where the control reads
three times what the program does.
"""

from __future__ import annotations

import importlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import harness
from portbench.reference import nets, steps

CHECKED_STEPS = 3
FAKES = ("fake_B", "fake_A")
MODULES = {"pix2pix": "pix2pix", "cycle_gan": "cyclegan"}


def program_args(cell, device, seed: int) -> List[str]:
    cfg, mix = cell["cfg"], cell["mix"]
    args = ["--model", cfg["model"], "--netG", cfg["netG"], "--ngf", str(cfg["ngf"]),
            "--netD", cfg["netD"], "--ndf", str(cfg["ndf"]), "--norm", cfg["norm"],
            "--input_nc", str(cfg["input_nc"]), "--output_nc", str(cfg["output_nc"]),
            "--compute_dtype", cfg["compute_dtype"], "--gan_mode", cfg["gan_mode"],
            "--pool_size", str(cfg["pool_size"]), "--lr", repr(cfg["lr"]),
            "--beta1", repr(cfg["beta1"]), "--batch_size", str(mix["batch"]),
            "--crop_size", str(mix["crop"]), "--steps_per_call", str(mix["steps_per_call"]),
            "--seed", str(seed), "--device", device.type]
    for key in ("lambda_L1", "lambda_A", "lambda_B", "lambda_identity"):
        if key in cfg:
            args += [f"--{key}", repr(cfg[key])]
    return args + ([] if cfg["dropout"] else ["--no_dropout"]) + list(cell["route"])


def specs_of(cfg) -> Dict[str, list]:
    i, o = cfg["input_nc"], cfg["output_nc"]
    if cfg["model"] == "pix2pix":
        return {"G": nets.unet_spec(i, o, cfg["ngf"], cfg["unet_downs"]),
                "D": nets.basic_d_spec(i + o, cfg["ndf"], cfg["norm"])}
    return {"G_A": nets.resnet_spec(i, o, cfg["ngf"], cfg["n_blocks"]),
            "G_B": nets.resnet_spec(o, i, cfg["ngf"], cfg["n_blocks"]),
            "D_A": nets.basic_d_spec(o, cfg["ndf"], cfg["norm"]),
            "D_B": nets.basic_d_spec(i, cfg["ndf"], cfg["norm"])}


def group_of(leaf: str) -> str:
    """The optimizer a leaf belongs to: G (G, G_A, G_B) or D."""
    return leaf[0]


def make_inputs(cell, seed: int, device):
    """The pool of distinct (K, B, H, W, C) stacks of A and B, uniform in
    [-1, 1], drawn on ``device``: (pool, K, B, H, W, C) each."""
    mix, cfg = cell["mix"], cell["cfg"]
    g = torch.Generator(device=device).manual_seed(harness.derive(seed, "inputs"))
    shape = (mix["pool"], mix["steps_per_call"], mix["batch"], mix["crop"], mix["crop"])
    a = torch.rand(shape + (cfg["input_nc"],), generator=g, device=device) * 2 - 1
    b = torch.rand(shape + (cfg["output_nc"],), generator=g, device=device) * 2 - 1
    return a, b


def step_input(pool, step: int):
    """Step ``step``'s (0-based) batch: call step // K, its step step % K."""
    k = pool.shape[1]
    return pool[(step // k) % pool.shape[0], step % k]


class Observed:
    """The program's train step as the call drives it, with a hook after
    each step (the first steps' readings) and, for the harness's own tests,
    a fault planted underneath: ``frozen`` (the state restored after every
    step), ``half`` (each step on the first half of its batch)."""

    def __init__(self, step_fn, fault: Optional[str] = None):
        self.step_fn, self.fault, self.hook = step_fn, fault, None

    def __call__(self, state, batch, generator):
        if self.fault == "half":
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        saved = ({k: v.detach().clone() for k, v in leaves(state).items()}
                 if self.fault == "frozen" else None)
        out = self.step_fn(state, batch, generator)
        if saved is not None:
            with torch.no_grad():
                for k, t in leaves(state).items():
                    t.copy_(saved[k])
        if self.hook is not None:
            self.hook(state, out[1])
        return out


def leaves(state) -> Dict[str, torch.Tensor]:
    """Every parameter and running average of the state, by net.name."""
    out = {}
    for net_name, net in state.nets.items():
        for n, p in net.named_parameters():
            out[f"{net_name}.{n}"] = p
        for n, b in net.named_buffers():
            if not n.endswith("num_batches_tracked"):
                out[f"{net_name}.{n}"] = b
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[k].detach().double().norm() for k in names]).tolist()
    return dict(zip(names, vals))


class FirstSteps:
    """The program's readings of its first steps: hook of ``Observed``.
    The first gradients are kept on the host, so that the program's peak
    memory stays its own."""

    def __init__(self, state, b1: float):
        self.b1, self.done = b1, 0
        self.start = {k: v.detach().clone() for k, v in leaves(state).items()}
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.grad_t: Dict[str, torch.Tensor] = {}
        self.fakes: Dict[str, torch.Tensor] = {}

    def __call__(self, state, visuals) -> None:
        self.done += 1
        if self.done == 1:
            self.fakes = {k: visuals[k].detach().float().cpu() for k in FAKES if k in visuals}
            mu = {n: m for opt in state.opts.values() for n, m in opt.mu.items()}
            self.grad_t = {k: (m.detach().float() / (1 - self.b1)).cpu() for k, m in mu.items()}
            self.grad = norms(self.grad_t)
        if self.done == CHECKED_STEPS:
            now = leaves(state)
            self.change = norms({k: now[k] - self.start[k] for k in now})
            self.start = {}


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The check's numbers (module docstring) from the two sides'
    readings: ``losses`` (a list of dicts, one per step), ``grad`` and
    ``change`` (norms by leaf), ``grad_t`` (the first gradients by leaf),
    ``fakes``. Each cell compares those its limits name."""

    def loss_gap(rows):
        return max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
                   for p, r in zip(prog["losses"], rows) for k in r)

    out = {"loss_gap": loss_gap(ref["losses"]), "loss1_gap": loss_gap(ref["losses"][:1])}
    found = {"grad_gap": [], "change_gap": [], "grad_diff": []}
    for group in sorted({group_of(k) for k in ref["grad"]}):
        g_ref = {k: v for k, v in ref["grad"].items() if group_of(k) == group}
        median = float(np.median(list(g_ref.values())))
        moved = {k: v for k, v in ref["change"].items() if group_of(k) == group
                 and (k not in g_ref or g_ref[k] >= 1e-3 * median)}
        found["grad_gap"].append(list(harness.leaf_gaps(prog["grad"], g_ref).values()))
        found["change_gap"].append(list(harness.leaf_gaps(prog["change"], moved).values()))
        found["grad_diff"].append(list(
            harness.leaf_diffs(prog["grad_t"], ref["grad_t"], g_ref).values()))
    for name, per_group in found.items():
        out[name] = max(max(g) for g in per_group)
        out[name + "_median"] = max(float(np.median(g)) for g in per_group)
    out["fake_rel_rms"] = 0.0
    for k, r in ref["fakes"].items():
        p = prog["fakes"].get(k)
        if p is None or p.shape != r.shape:
            out["fake_rel_rms"] = float("inf")
            break
        r = r.double()
        out["fake_rel_rms"] = max(out["fake_rel_rms"], float(
            (p.double() - r).square().mean().sqrt() / r.square().mean().sqrt()))
    return out


def reference_readings(cell, seed: int, device, pool_a, pool_b, quant=None) -> dict:
    """Three steps of the plain reference from the seeded weights and the
    program's first inputs: its losses, first gradients' norms and changes'
    norms, by leaf."""
    cfg, mix = cell["cfg"], cell["mix"]
    harness.exact_f32()
    params = harness.make_params(specs_of(cfg), seed, device)
    if cfg["model"] == "pix2pix":
        buffers = {n: nets.bn_buffers(s, device) for n, s in specs_of(cfg).items()}
        ref = steps.Pix2PixRef(cfg, params, buffers, quant)
    else:
        buffers = {}
        ref = steps.CycleGANRef(cfg, params, mix["crop"], device, quant,
                                mix.get("reference_chunk", 0))
    start = {f"{n}.{k}": v.clone() for n, p in params.items() for k, v in p.items()}
    start.update({f"{n}.{k}": v.clone() for n, b in buffers.items() for k, v in b.items()})
    del params
    losses, grad_t, first_fakes = [], {}, {}
    for s in range(CHECKED_STEPS):
        ls, grads, fakes = ref.step(step_input(pool_a, s), step_input(pool_b, s), seed, s)
        losses.append(ls)
        if s == 0:
            for g in grads.values():
                grad_t.update({k: v.detach() for k, v in g.items()})
            first_fakes = {k: v.float().cpu() for k, v in fakes.items()}
    now = {f"{n}.{k}": v for n, p in ref.P.items() for k, v in p.items()}
    if cfg["model"] == "pix2pix":
        now.update({f"{n}.{k}": v for n, b in ref.buffers.items() for k, v in b.items()})
    change = norms({k: now[k] - start[k] for k in start})
    return {"losses": losses, "grad": norms(grad_t), "change": change, "grad_t": grad_t,
            "fakes": first_fakes}


def build(cell, device, seed: int, fault: Optional[str]):
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.models.common import make_scan_step

    model = importlib.import_module("biasgan_tpu_torch.models." + MODULES[cell["cfg"]["model"]])
    pcfg = parse_config(program_args(cell, device, seed), train=True)
    pcfg.steps_per_epoch = 1 << 40  # the first epoch's constant learning rate
    state = model.create_state(pcfg, device)
    params = harness.make_params(specs_of(cell["cfg"]), seed, device)
    for net, p in params.items():
        harness.load_into(state.nets[net], p, net)
    observed = Observed(model.make_train_step(pcfg), fault)
    call = make_scan_step(observed, pcfg.steps_per_call, seed)
    return state, observed, call


def drive(state, call, pool_a, pool_b, n: Optional[int], seconds: float, first_call: int,
          sync):
    """Calls until ``n`` are made or ``seconds`` have passed, then a
    synchronize; returns (calls, window seconds, the calls' losses)."""
    rf = torch.autograd.profiler.record_function
    made, out, t_start = 0, [], time.perf_counter()
    while True:
        j = (first_call + made) % pool_a.shape[0]
        with rf(harness.SPAN + "train.call"):
            losses, _ = call(state, {"A": pool_a[j], "B": pool_b[j]}, state.step)
        out.append(losses)
        made += 1
        if (n is not None and made >= n) or (
                n is None and time.perf_counter() - t_start >= seconds):
            break
    with rf(harness.SPAN + "train.sync"):
        sync()
    return made, time.perf_counter() - t_start, out


def loss_rows(calls: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """One dict of losses per step, in order."""
    rows = []
    for losses in calls:
        names = list(losses)
        vals = torch.stack([losses[k].float() for k in names]).T.tolist()
        rows += [dict(zip(names, v)) for v in vals]
    return rows


def run(cell, seed: int, seconds: float, trace: bool, device, t_origin: float,
        fault: Optional[str] = None) -> dict:
    mix, cfg = cell["mix"], cell["cfg"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    state, observed, call = build(cell, device, seed, fault)
    pool_a, pool_b = make_inputs(cell, seed, device)
    first = FirstSteps(state, cfg["beta1"])
    observed.hook = first
    warm = -(-CHECKED_STEPS // mix["steps_per_call"])
    calls, _, warm_losses = drive(state, call, pool_a, pool_b, warm, 0.0, 0, sync)
    observed.hook = None
    prog = {"losses": loss_rows(warm_losses)[:CHECKED_STEPS], "grad": first.grad,
            "change": first.change, "grad_t": first.grad_t, "fakes": first.fakes}
    more = max(mix["warmup_calls"] - calls, 0)
    if more:
        drive(state, call, pool_a, pool_b, more, 0.0, calls, sync)
    calls += more
    setup_s = time.perf_counter() - t_origin
    reading, window_losses = None, []

    def window_of(n_calls, secs):
        nonlocal calls
        made, window, losses = drive(state, call, pool_a, pool_b, n_calls, secs, calls, sync)
        calls += made
        window_losses.extend(losses)
        return made * mix["steps_per_call"], window

    if trace:
        reading = harness.traced(cell, lambda: window_of(mix["trace_calls"], 0.0),
                                 lambda: window_of(mix["trace_labelled"], 0.0),
                                 {"batch": mix["batch"], "crop": mix["crop"]})
        n_steps, window = reading.trace.units, reading.trace.window_s
    else:
        n_steps, window = window_of(None, seconds)
    rows = loss_rows(window_losses)
    failed = sum(not all(np.isfinite(list(r.values()))) for r in rows)
    device_info = harness.device_block(device, cell["chips"])
    del state, observed, call
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference_readings(cell, seed, device, pool_a, pool_b)
    found = numbers(prog, ref)
    ok, checks = harness.judge(found, cell["limits"])
    print(f"portbench: the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    metrics = {"setup_s": {"value": setup_s, "unit": "s"},
               cell["rate"]: {"value": n_steps * mix["batch"] / window, "unit": "samples/s"}}
    return {"correct": ok and failed == 0, "attempted": n_steps, "failed": failed,
            "metrics": metrics, "device": device_info, "reading": reading, "checks": checks,
            "numbers": found}
