"""The port's spans (``biasgan_tpu_torch/trace.py``) on the CPU: off, a
span is the one shared null context and enters no ``record_function``;
on, a ``torch.profiler`` run of a tiny served field, of tiny pix2pix and
CycleGAN steps (a data context of one rank) and of a kernel launch (a
faked library and stream) shows each span nested where it belongs; the
data context counts its grads' all-reduces; ``profile_globe``'s reader of
the served field's spans counts the host-blocking calls inside a call."""

import contextlib
import types
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from biasgan_tpu_torch import infer, profile_globe, trace
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.kernels import build, common
from biasgan_tpu_torch.models.common import generator_of, make_scan_step
from biasgan_tpu_torch.parallel import DataCtx
from biasgan_tpu_torch.registry import get_model

SERVE = ["--model", "cycle_gan", "--netG", "resnet_2blocks", "--ngf", "8", "--norm",
         "instance", "--input_nc", "1", "--output_nc", "1", "--w_pad_mode", "wrap",
         "--netG_activation", "none", "--no_dropout", "--device", "cpu", "--fused_blocks",
         "--fused_updown", "--conv7_pallas", "1"]
TRAIN = ["--dataset_mode", "synthetic", "--ngf", "8", "--ndf", "8", "--input_nc", "1",
         "--output_nc", "1", "--crop_size", "32", "--batch_size", "2", "--n_epochs", "1",
         "--n_epochs_decay", "0", "--device", "cpu"]
CYCLE = TRAIN + ["--model", "cycle_gan", "--netG", "resnet_2blocks", "--norm", "instance",
                 "--no_dropout", "--pool_size", "4"]
P2P = TRAIN + ["--model", "pix2pix", "--netG", "unet_d4"]
G_STAGES = {"port.G.stem", "port.G.down", "port.G.blocks", "port.G.up", "port.G.head"}


def spans_of(prof):
    """Each ``port.`` span's count, and the names of the nearest ``port.``
    spans around it (None at the top)."""
    counts, parents = Counter(), {}
    for e in prof.events():
        if not e.name.startswith("port."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("port."):
            p = p.cpu_parent
        counts[e.name] += 1
        parents.setdefault(e.name, set()).add(None if p is None else p.name)
    return counts, parents


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.enabled():
        fn()
    return spans_of(prof)


def tiny_runner():
    cfg = parse_config(SERVE, train=False)
    G = generator_of(cfg, 1, 1, fused_updown=True).eval()
    run = infer.field_runner(G, *infer.pad_multiples(cfg.netG))
    x = torch.randn(1, 9, 16, 1)
    stats = (torch.zeros(1), torch.ones(1), torch.zeros(1), torch.ones(1))
    return lambda: run(x, *stats)


def test_off_spans_are_one_null_context_and_enter_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: entered.append(name) or contextlib.nullcontext())
    assert trace.span("port.a") is trace.span("port.b")
    assert isinstance(trace.span("port.a"), contextlib.nullcontext)
    tiny_runner()()
    assert entered == []
    with trace.enabled():
        with trace.span("port.a"), trace.enabled():
            pass
        with trace.span("port.d"):
            pass
    assert entered == ["port.a", "port.d"]
    assert trace.span("port.e") is trace.span("port.f")


def test_served_field_spans_nest():
    counts, parents = traced(tiny_runner())
    assert parents["port.serve.field_runner"] == {None}
    for phase in ("standardize", "pad", "G", "crop"):
        assert parents[f"port.serve.{phase}"] == {"port.serve.field_runner"}
    for stage in G_STAGES:
        assert parents[stage] == {"port.serve.G"}, stage
    # H 9 -> 12 reflects; the 7x7 stem and head pad H (reflect) and W
    # (wrap); on the CPU the fused convs' plain versions pad too
    assert {"port.serve.pad", "port.G.stem", "port.G.head"} <= parents["port.pad"]
    assert parents["port.pad"] <= {"port.serve.pad"} | G_STAGES
    assert counts["port.pad"] >= 5 and counts["port.serve.field_runner"] == 1


@pytest.mark.parametrize("argv,k,phases,stages", [
    (P2P, 2, ("prepare", "G_forward", "D", "D_update", "G_backward", "G_update"),
     {"port.G.down", "port.G.up"}),
    (CYCLE, 1, ("prepare", "G_forward", "G_backward", "G_update", "pools", "D", "D_update"),
     G_STAGES),
], ids=["pix2pix", "cycle_gan"])
def test_step_spans_nest(argv, k, phases, stages):
    cfg = parse_config(argv, train=True)
    model = get_model(cfg.model)
    state = model.create_state(cfg, torch.device("cpu"))
    data = DataCtx(1)
    call = make_scan_step(model.make_train_step(cfg, data=data), k, cfg.seed)
    g = torch.Generator().manual_seed(0)
    stacked = {n: torch.rand((k, 2, 32, 32, 1), generator=g) * 2 - 1 for n in ("A", "B")}
    counts, parents = traced(lambda: call(state, stacked, 0))
    assert counts["port.step"] == k and parents["port.step"] == {None}
    assert {n for n in counts if n.startswith("port.step.")} == {
        f"port.step.{p}" for p in phases + ("grad_reduce",)}
    for p in phases:
        assert parents[f"port.step.{p}"] == {"port.step"} and counts[f"port.step.{p}"] == k
    assert parents["port.step.grad_reduce"] == {"port.step.G_update", "port.step.D_update"}
    assert counts["port.step.grad_reduce"] == 2 * k and data.grad_reduces == 2 * k
    assert {n for n in counts if n.startswith("port.G.")} == stages
    for stage in stages:
        assert parents[stage] == {"port.step.G_forward"}, stage
    assert parents.get("port.pad", set()) <= G_STAGES


def test_kernel_launch_span_names_the_wrapper(monkeypatch):
    """``kernels.common.launch``, the one way to a hand-written kernel,
    runs in ``port.kernel.<wrapper>`` (a faked library, device and stream:
    the CPU has none)."""
    called = []

    def fn(*args):
        called.append(args)
        return 0

    fn.argtypes = []
    monkeypatch.setattr(build, "load", lambda name: types.SimpleNamespace(entry=fn))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    cpu = torch.device("cpu")

    def launches():
        common.launch("conv3x3_fused_bwd", "entry", [], cpu, 1)
        common.launch("halo_exchange", "entry", [], cpu, 2)

    counts, parents = traced(launches)
    assert called == [(1, 7), (2, 7)]
    assert counts == {"port.kernel.conv3x3_fused_bwd": 1, "port.kernel.halo_exchange_w": 1}
    assert {f"port.kernel.{w}" for _, w in build.SOURCES.values()} >= set(counts)
    assert parents["port.kernel.halo_exchange_w"] == {None}


# host events as profile_globe.host_events gives them: (name, start us, end us)
CALL = [("port.serve.field_runner", 0, 1000), ("port.serve.pad", 10, 100),
        ("port.pad", 20, 90), ("port.serve.G", 100, 900), ("port.G.head", 700, 900),
        ("port.pad", 710, 850)]


@pytest.mark.parametrize("events,fields,want", [
    # a sync in pad_field's pad and one in the head's, both inside the call
    (CALL + [("cudaStreamSynchronize", 30, 80), ("cudaStreamSynchronize", 720, 840)], 1,
     {"port.pad < port.serve.pad": (1, 0.05), "port.pad < port.G.head": (1, 0.12)}),
    # the copy to the host after the call, and a sync before it, are not counted
    (CALL + [("cudaStreamSynchronize", 1100, 1300), ("cudaMemcpy", -50, -10),
             ("cudaDeviceSynchronize", 400, 410)], 1,
     {"port.serve.G < port.serve.field_runner": (1, 0.01)}),
    # two calls: per field
    (CALL + [("cudaStreamSynchronize", 720, 840)]
     + [(n, a + 2000, b + 2000) for n, a, b in CALL + [("cudaStreamSynchronize", 720, 840)]],
     2, {"port.pad < port.G.head": (1, 0.12)}),
    # the call's span and no sync inside it
    (CALL, 1, {}),
], ids=["inside", "outside", "per_field", "none"])
def test_serve_spans_count_blocking_calls_inside_the_call(events, fields, want):
    got = profile_globe.serve_spans(events, fields)
    assert got["syncs_by_span"].keys() == want.keys()
    for key, (n, ms) in want.items():
        assert got["syncs_by_span"][key] == pytest.approx((n, ms))
    assert got["syncs_per_field"] == pytest.approx(sum(n for n, _ in want.values()))
    assert got["sync_ms_per_field"] == pytest.approx(sum(ms for _, ms in want.values()))
    assert got["span_ms_per_field"]["port.serve.field_runner"] == pytest.approx(1.0)
    assert got["span_ms_per_field"]["port.pad"] == pytest.approx(0.21)


def test_serve_spans_read_a_profile_of_served_fields():
    """``profile_globe``'s spans round on the CPU: a profile of two tiny
    served fields with the spans on gives every serving span and no
    host-blocking call (a CPU pad uploads nothing)."""
    run = tiny_runner()
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.enabled():
        run()
        run()
    got = profile_globe.serve_spans(profile_globe.host_events(prof), 2)
    assert {f"port.serve.{p}" for p in ("field_runner", "standardize", "pad", "G", "crop")} \
        | G_STAGES | {"port.pad"} <= set(got["span_ms_per_field"])
    assert got["syncs_per_field"] == 0 and got["syncs_by_span"] == {}
    ms = got["span_ms_per_field"]
    assert 0 < ms["port.serve.G"] <= ms["port.serve.field_runner"]
