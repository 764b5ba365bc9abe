"""serve.roofline.block_conv: the resnet block convs' share of their
roofline, in %: the bound of the generator's 2 x n_blocks block convs a
call, from their shapes at the call's batch (``work.block_conv_bound_s``),
over the device time of the kernels that implement them, the block conv
kernel (``conv_tma_kernel``) and the moment reduce that follows each launch
of it. Moves serve_fields_per_s. Nothing to read where no block conv
kernel ran."""

from portbench import work
from portbench.harness import is_handwritten

UNIT = "%"
KERNEL = "conv_tma_kernel"
FOLLOWER = "reduce_moments_kernel"


def read(r):
    if r.kind != "serve":
        return None
    us, calls, prev = 0.0, 0, ""
    for name, a, b in r.trace.kernels:
        if not is_handwritten(name):
            continue
        if KERNEL in name:
            us, calls = us + (b - a), calls + 1
        elif FOLLOWER in name and KERNEL in prev:
            us += b - a
        prev = name
    if not calls:
        return None
    cfg, n = r.cell["cfg"], r.extra["batch"]
    h, w = (-(-x // 4) * 4 // 4 for x in r.extra["field"])
    bound = 2 * cfg["n_blocks"] * work.block_conv_bound_s(n, h, w, 4 * cfg["ngf"])
    return 100.0 * bound * (r.trace.units // n) / (us / 1e6)
