"""serve.mfu: the served field's share of the chip's bf16 peak, in %: the
bench's own FLOP count of one field (the generator's forward at the padded
field size, ``work.field_flops``) times the fields of the traced window,
over the window and the peak. Moves serve_fields_per_s."""

from portbench import work

UNIT = "%"


def read(r):
    if r.kind != "serve" or not r.trace.ops:
        return None
    h, w = (-(-n // 4) * 4 for n in r.extra["field"])
    flops = work.field_flops(r.cell["cfg"], h, w) * r.trace.units
    return 100.0 * flops / r.trace.window_s / work.PEAK_BF16_FLOPS
