"""serve.glue_ms: device ms a field in kernels that are not the port's
hand-written ones (pads, casts, affines, elementwise passes, library
convs), from the traced window's device kernels; copies and memsets are
not kernels and not counted. Moves serve_fields_per_s."""

from portbench.harness import is_handwritten

UNIT = "ms"


def read(r):
    if r.kind != "serve" or not r.trace.ops:
        return None
    us = sum(b - a for name, a, b in r.trace.kernels if not is_handwritten(name))
    return us / 1e3 / r.trace.units
