"""serve.host_runner_ms: the host's ms a call inside the program's
``field_runner``, from the call to its return (the median over the traced
window's calls; the profiler traces device activity meanwhile). It holds
the enqueueing of the call's device work and any wait for the card inside
the forward (a synchronous copy); where it nears a call's time, the host
cannot run ahead of the card and paces it. Moves serve_fields_per_s."""

import numpy as np

UNIT = "ms"


def read(r):
    runner_ms = r.extra.get("runner_ms")
    if r.kind != "serve" or not runner_ms:
        return None
    return float(np.median(runner_ms))
