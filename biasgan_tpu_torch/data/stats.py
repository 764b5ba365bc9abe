"""Per-variable standardization statistics for climate fields.

Counterpart of ``biasgan_tpu/data/stats.py``: streams over the files
accumulating sum/sumsq per variable (one pass, O(1) memory) and caches the
result as JSON next to the data. The JSON is the same as the JAX package's,
so either package reuses the other's cache.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np

# cap per-read slab size so multi-year (T, H, W) archives never materialize
# whole on the host (tens of GB); ~256 MB of float64 per slab
_SLAB_BYTES = 256 * 1024 * 1024


def _iter_slabs(ds):
    """Yield float64 chunks of a 2-D/3-D dataset, slabbed along axis 0."""
    if ds.ndim < 3:
        yield np.asarray(ds[...], dtype=np.float64)
        return
    frame_bytes = int(np.prod(ds.shape[1:])) * 8
    step = max(1, _SLAB_BYTES // max(frame_bytes, 1))
    for i in range(0, ds.shape[0], step):
        yield np.asarray(ds[i : i + step], dtype=np.float64)


def compute_stats(
    files: Sequence[str], variables: Sequence[str]
) -> Dict[str, Dict[str, float]]:
    from biasgan_tpu_torch.data import ncio

    acc = {v: [0.0, 0.0, 0] for v in variables}  # sum, sumsq, count
    for path in files:
        f = ncio.open_field_file(path)
        try:
            for v in variables:
                for arr in _iter_slabs(f[v]):
                    acc[v][0] += float(arr.sum())
                    acc[v][1] += float(np.square(arr).sum())
                    acc[v][2] += int(arr.size)
        finally:
            f.close()
    out = {}
    for v, (s, s2, n) in acc.items():
        mean = s / max(n, 1)
        var = max(s2 / max(n, 1) - mean * mean, 0.0)
        out[v] = {"mean": mean, "std": float(np.sqrt(var)) or 1.0}
    return out


def load_or_compute_stats(
    stats_path: str, files: Sequence[str], variables: Sequence[str]
) -> Dict[str, Dict[str, float]]:
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            stats = json.load(f)
        if all(v in stats for v in variables):
            return stats
    stats = compute_stats(files, variables)
    os.makedirs(os.path.dirname(stats_path) or ".", exist_ok=True)
    with open(stats_path, "w") as f:
        json.dump(stats, f, indent=2)
    return stats


def stats_arrays(
    stats: Dict[str, Dict[str, float]], variables: Sequence[str]
) -> tuple:
    mean = np.array([stats[v]["mean"] for v in variables], np.float32)
    std = np.array([stats[v]["std"] for v in variables], np.float32)
    return mean, std
