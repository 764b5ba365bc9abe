"""The check fails what it must: the control (the reference one precision
below the configuration's, in fp8, in the program's place) and the faults
each cell can have, planted under the timed path, each come out not
correct by the cell's own limits, at sizes a CPU test can hold. The
program runs in f32 here, where it agrees with the reference to rounding
(``test_portbench_reference``), so what fails is the fault's doing."""

import pytest
import torch

from portbench import harness
from portbench.drivers import train
from portbench.reference.steps import fp8_quant
from portbench.tests.tiny import SEED, SERVE, TRAIN, run, tiny_cell


def f32(name):
    cell = tiny_cell(name)
    cell["cfg"]["compute_dtype"] = "float32"
    return cell


def test_serve_control_fails():
    out = run(f32(SERVE), fault="control")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_fails(name):
    cell = tiny_cell(name)
    dev = torch.device("cpu")
    a, b = train.make_inputs(cell, SEED, dev)
    low = train.reference_readings(cell, SEED, dev, a, b, fp8_quant)
    ref = train.reference_readings(cell, SEED, dev, a, b)
    ok, checks = harness.judge(train.numbers(low, ref), cell["limits"])
    assert not ok, checks


def test_serve_altered_answer_fails():
    out = run(f32(SERVE), fault="answer")
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("fault", ["frozen", "half"])
@pytest.mark.parametrize("name", TRAIN)
def test_train_faults_fail(name, fault):
    out = run(f32(name), fault=fault)
    assert not out["correct"], out["checks"]
