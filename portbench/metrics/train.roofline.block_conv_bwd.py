"""train.roofline.block_conv_bwd: the backward of the resnet block convs
on the fused block route (K2's backward), its share of its roofline, in
%: the bound of every back-propagated generator pass's 2 x n_blocks block
conv backwards a step (input and weight gradients,
``work.block_conv_bwd_bound_s``) over the device time of the kernels of
those backward calls: each call's hand-written launches from its
``prep_kernel`` to its ``reduce_kernel`` (prep, the input gradient, the
weight gradient, the reduce). Moves cyclegan_train_samples_per_s. Nothing
to read where the backward kernel did not run."""

from portbench import work
from portbench.harness import is_handwritten

UNIT = "%"
FIRST, LAST = "::prep_kernel", "::reduce_kernel"


def read(r):
    if r.kind != "train" or not r.launches.get("conv3x3_fused_bwd"):
        return None
    us, calls, inside = 0.0, 0, False
    for name, a, b in r.trace.kernels:
        if not is_handwritten(name):
            continue
        if FIRST in name:
            inside, calls = True, calls + 1
        if inside:
            us += b - a
        if LAST in name:
            inside = False
    if not calls:
        return None
    cfg, crop = r.cell["cfg"], r.extra["crop"]
    c, hw = 4 * cfg["ngf"], crop // 4
    bound = sum(2 * cfg["n_blocks"] * work.block_conv_bwd_bound_s(n, hw, hw, c)
                for n in work.generator_passes(cfg, r.extra["batch"]))
    return 100.0 * bound * r.trace.units / (us / 1e6)
