"""train.idle_share: the share of the traced window in which no
operation ran on the device, in %: 1 - busy / window, busy the union of
the device operations' intervals. Split by cell as
``train.idle_share.<model>``, each moving its cell's rate
(``<model>_train_samples_per_s``)."""

UNIT = "%"


def read(r):
    if r.kind != "train" or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
