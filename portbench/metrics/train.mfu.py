"""train.mfu: the training step's share of the chip's bf16 peak, in %:
the bench's own FLOP count of a step (``work.step_flops``: the forward of
every pass and the gradient products of every back-propagated one) times
the steps of the traced window, over the window and the peak. Split by
cell as ``train.mfu.<model>``, each moving its cell's rate
(``<model>_train_samples_per_s``)."""

from portbench import work

UNIT = "%"


def read(r):
    if r.kind != "train" or not r.trace.ops:
        return None
    flops = work.step_flops(r.cell["cfg"], r.extra["batch"], r.extra["crop"]) * r.trace.units
    return 100.0 * flops / r.trace.window_s / work.PEAK_BF16_FLOPS
