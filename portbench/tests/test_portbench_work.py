"""The bench's FLOP counts against ``torch.utils.flop_counter`` over the
plain reference, at small sizes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, work
from portbench.drivers import serve, train
from portbench.reference import nets, steps
from portbench.tests.tiny import SERVE, TRAIN, tiny_cell


def counted(fn):
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


def test_field_flops():
    cell = tiny_cell(SERVE)
    cfg = cell["cfg"]
    P = harness.make_params({"G": serve.spec_of(cfg)}, 1, torch.device("cpu"))["G"]
    x = torch.randn(1, 24, 40, 3)
    flops = counted(lambda: nets.resnet_g(P, x, cfg["n_blocks"], "wrap", "none"))
    assert flops == work.field_flops(cfg, 24, 40)


@pytest.mark.parametrize("name", TRAIN)
def test_step_flops(name):
    cell = tiny_cell(name)
    cfg, mix = cell["cfg"], cell["mix"]
    dev = torch.device("cpu")
    params = harness.make_params(train.specs_of(cfg), 1, dev)
    if cfg["model"] == "pix2pix":
        bufs = {n: nets.bn_buffers(s, dev) for n, s in train.specs_of(cfg).items()}
        ref = steps.Pix2PixRef(cfg, params, bufs)
    else:
        ref = steps.CycleGANRef(cfg, params, mix["crop"], dev)
    shape = (mix["batch"], mix["crop"], mix["crop"], 3)
    a, b = torch.rand(shape) * 2 - 1, torch.rand(shape) * 2 - 1
    flops = counted(lambda: ref.step(a, b, 3, 0))
    assert flops == work.step_flops(cfg, mix["batch"], mix["crop"])


def test_full_size_counts():
    """The published configurations' counts (the numbers PERF.md quotes)."""
    c = harness.load_cell(SERVE)["cfg"]
    assert work.field_flops(c, 724, 1440) == 1576550891520
    p = harness.load_cell("pix2pix_unet256.train_b128")["cfg"]
    assert work.step_flops(p, 1, 256) == 86940057600
    assert work.step_flops(c, 1, 256) == 1881683263488
    assert abs(work.block_conv_bound_s(1, 181, 360, 256) - 7.772079e-05) < 1e-10
