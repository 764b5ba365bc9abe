"""The plain reference against the program at tiny sizes on the CPU: the
program computing in f32 agrees with the reference to rounding, through
the harness's own run and check (set-up, window, the numbers)."""

import pytest

from portbench.tests.tiny import CYCLE, SERVE, TRAIN, run, tiny_cell

CELLS = [SERVE] + TRAIN
# f32 program against the f32 reference: the served field to rounding;
# the training steps' first gradients (norms and differences) to rounding,
# their losses and three-step changes within what Adam's sign-like first
# steps make of rounding (the CycleGAN step at init moves its fakes ~3e3
# times an input perturbation)
F32 = {"field_rel_rms": 1e-5, "field_max_gap": 1e-4, "loss_gap": 2e-3, "loss1_gap": 1e-4,
       "grad_gap": 1e-4, "grad_gap_median": 1e-4, "change_gap": 1e-2, "change_gap_median": 1e-2,
       "grad_diff": 1e-4, "grad_diff_median": 1e-4, "fake_rel_rms": 1e-5}


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_in_f32(name):
    cell = tiny_cell(name)
    cell["cfg"]["compute_dtype"] = "float32"
    out = run(cell)
    assert out["attempted"] >= 1 and out["failed"] == 0 and out["correct"]
    for k, v in out["numbers"].items():
        assert v <= F32[k], (k, v)


def test_pool_replay_branch_matches():
    """Past the pool's fill the replay draws decide: four steps of batch 2
    fill a pool of 4, the next draw replays."""
    cell = tiny_cell(CYCLE)
    cell["cfg"].update(compute_dtype="float32", pool_size=4)
    out = run(cell)
    assert out["numbers"]["loss_gap"] <= F32["loss_gap"]


def test_micro_batched_reference_is_the_same_step():
    """The CycleGAN reference on micro-batches (``reference_chunk``, which
    lets a large batch fit) takes the step it takes on the whole batch."""
    import torch

    from portbench.drivers import train

    cell = tiny_cell(CYCLE)
    cell["mix"].update(batch=4, pool=1)
    cell["cfg"]["pool_size"] = 6
    dev = torch.device("cpu")
    a, b = train.make_inputs(cell, 5, dev)
    whole = train.reference_readings(cell, 5, dev, a, b)
    cell["mix"]["reference_chunk"] = 3
    parts = train.reference_readings(cell, 5, dev, a, b)
    for k, v in train.numbers(parts, whole).items():
        assert v <= 1e-4, (k, v)
