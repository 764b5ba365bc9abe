"""serve.call_ms_p95: the 95th percentile over the traced window's calls
of a call's device span, from its first device operation to the end of its
copy to the host, in ms. Each call ends in one device-to-host copy and a
synchronize, so a call's operations are those after the previous call's
copy up to its own. Moves serve_fields_per_s (a closed loop of one
client: its latency is what the rate does not say about the tail)."""

import numpy as np

UNIT = "ms"
COPY = "Memcpy DtoH"


def read(r):
    if r.kind != "serve" or not r.trace.ops:
        return None
    spans, first = [], None
    for name, a, b in r.trace.ops:
        if first is None:
            first = a
        if name.startswith(COPY):
            spans.append(b - first)
            first = None
    if not spans:
        return None
    return float(np.percentile(spans, 95)) / 1e3
