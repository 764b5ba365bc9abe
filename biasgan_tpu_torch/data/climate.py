"""Climate field dataset: HDF5 / NetCDF ingestion of gridded fields.

Counterpart of ``biasgan_tpu/data/climate.py``: readers for multi-variable
2-D fields (precip/T2m/SLP-class), per-variable standardization stats,
patch sampling from global grids with periodic-longitude wraparound, and
whole-grid reads for full-field inference. Each file holds one dataset per
variable with shape (T, H, W) or (H, W); variables are stacked on the
channel axis. Samples are numpy; infer.py standardizes them on its device
with the (C,) stats that ride along in the batch.

NetCDF-4 / HDF5 files need h5py; classic NetCDF-3 files read through scipy
on a host without it (data/ncio.py).

Paired mode ('climate'): <dataroot>/<phase>A/*.{h5,nc} (e.g. model/sim) and
<dataroot>/<phase>B/ (obs), aligned by sorted file order and time index.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from biasgan_tpu_torch.data import ncio
from biasgan_tpu_torch.data import stats as stats_mod
from biasgan_tpu_torch.data import transforms
from biasgan_tpu_torch.registry import register_dataset


@dataclass
class ClimateConfig:
    variables: str = ""  # comma-separated dataset names ('' = autodetect)
    stats_file: str = ""  # JSON cache path ('' = <dataroot>/stats_<side>.json)
    paired_time: bool = True  # pair A/B samples by identical (file, t) index
    full_field: bool = False  # return whole grids (inference / full-globe)


class _Side:
    """One domain (A or B): a list of HDF5/NetCDF files + per-variable stats."""

    def __init__(self, cfg, side: str):
        root = os.path.join(cfg.dataroot, cfg.phase + side)
        if not os.path.isdir(root):  # single-dir fallback: dataroot/<phase>
            root = os.path.join(cfg.dataroot, cfg.phase)
        pats = ("*.h5", "*.hdf5", "*.nc", "*.nc4")
        self.files = sorted(p for pat in pats for p in glob(os.path.join(root, pat)))
        if not self.files:
            raise FileNotFoundError(f"no HDF5/NetCDF files under {root}")
        self.variables = (
            [v for v in cfg.variables.split(",") if v]
            if cfg.variables
            else ncio.discover_variables(self.files[0])
        )
        stats_path = cfg.stats_file or os.path.join(
            cfg.dataroot, f"stats_{side or 'A'}.json"
        )
        if cfg.stats_file and side == "B":
            stats_path = cfg.stats_file + ".B"
        st = stats_mod.load_or_compute_stats(stats_path, self.files, self.variables)
        self.mean, self.std = stats_mod.stats_arrays(st, self.variables)
        self._index: List[Tuple[int, int]] = []  # (file_idx, time_idx)
        self._handles: Dict[int, object] = {}
        self._dsets: Dict[Tuple[int, str], object] = {}

        for fi, path in enumerate(self.files):
            f = ncio.open_field_file(path)
            try:
                ds = f[self.variables[0]]
                t = ds.shape[0] if ds.ndim == 3 else 1
            finally:
                f.close()
            self._index.extend((fi, ti) for ti in range(t))

    def __len__(self) -> int:
        return len(self._index)

    def _file(self, fi: int):
        if fi not in self._handles:
            self._handles[fi] = ncio.open_field_file(self.files[fi])
        return self._handles[fi]

    def _dataset(self, fi: int, v: str):
        """Per-(file, variable) read accessor, cached.

        Fast path: CONTIGUOUS uncompressed HDF5 datasets are re-exposed as a
        read-only ``np.memmap`` — h5py's hyperslab machinery costs ~1 ms per
        read call (it dominated the loader profile at 59 samples/s
        single-thread; 768 h5py reads per 128 samples), while memmap slicing
        off the page cache is microseconds. Chunked/compressed datasets (and
        netCDF-3, which scipy already mmaps) keep their handle."""
        key = (fi, v)
        ds = self._dsets.get(key)
        if ds is not None:
            return ds
        f = self._file(fi)
        ds = f[v]
        h5py = ncio.h5py_module()
        if (
            h5py is not None
            and isinstance(ds, h5py.Dataset)
            and ds.chunks is None
            and ds.compression is None
            and ds.dtype.kind in "fiu"
        ):
            off = ds.id.get_offset()
            if off is not None:
                ds = np.memmap(
                    self.files[fi], dtype=ds.dtype, mode="r",
                    offset=off, shape=ds.shape,
                )
        self._dsets[key] = ds
        return ds

    def close(self) -> None:
        # drop dataset accessors FIRST: scipy's mmap'd netCDF-3 files
        # refuse to unmap while variable refs are alive (RuntimeWarning)
        self._dsets.clear()
        for h in self._handles.values():
            h.close()
        self._handles.clear()

    def __del__(self):  # handle cleanup at garbage collection
        if hasattr(self, "_dsets"):  # __init__ may have raised first
            self.close()

    def grid_shape(self) -> Tuple[int, int]:
        f = self._file(0)
        ds = f[self.variables[0]]
        return tuple(ds.shape[-2:])

    def read(
        self, index: int, window: Optional[Tuple[int, int, int, int]] = None
    ) -> np.ndarray:
        """Read (H, W, C) raw field; window=(y, x, h, w) slab with periodic
        wraparound on the longitude (last) axis."""
        fi, ti = self._index[index % len(self._index)]
        chans = []
        for v in self.variables:
            ds = self._dataset(fi, v)
            H, W = ds.shape[-2:]
            if window is None:
                arr = ds[ti] if ds.ndim == 3 else ds[...]
            else:
                y, x, h, w = window
                x = x % W
                ysl = slice(y, y + h)
                if x + w <= W:
                    arr = ds[ti, ysl, x : x + w] if ds.ndim == 3 else ds[ysl, x : x + w]
                else:  # periodic-longitude wraparound patch
                    k = W - x
                    if ds.ndim == 3:
                        arr = np.concatenate(
                            [ds[ti, ysl, x:], ds[ti, ysl, : w - k]], axis=-1
                        )
                    else:
                        arr = np.concatenate([ds[ysl, x:], ds[ysl, : w - k]], axis=-1)
            chans.append(np.asarray(arr, np.float32))
        return np.stack(chans, axis=-1)


@register_dataset("climate", ClimateConfig)
class ClimateDataset:
    """Paired (A: model/sim, B: obs) gridded-field dataset."""

    @staticmethod
    def config_defaults(train: bool):
        # climate fields: in-step flip augmentation, unbounded standardized
        # outputs
        return {"in_graph_aug": True, "netG_activation": "none"}

    def __init__(self, cfg):
        self.cfg = cfg
        self.A = _Side(cfg, "A")
        self.B = _Side(cfg, "B")
        self.full = cfg.full_field or cfg.preprocess == "none"
        self.crop = cfg.crop_size
        self.grid = self.A.grid_shape()
        if not self.full and self.crop > min(self.grid):
            raise ValueError(f"crop_size {self.crop} exceeds grid {self.grid}")

    def __len__(self) -> int:
        return max(len(self.A), len(self.B))

    def __getitem__(self, index: int) -> Dict:
        cfg = self.cfg
        # deterministic per (--seed, epoch, index): reproducible crops and
        # B-pairings (the loader advances self.epoch so crops still vary
        # across epochs)
        rng = transforms.sample_rng(cfg.seed, getattr(self, "epoch", 0), index)
        if cfg.paired_time:
            ia = ib = index
        else:
            ia = index
            ib = (
                index % len(self.B)
                if cfg.serial_batches
                else int(rng.integers(0, len(self.B)))
            )
        if self.full:
            window = None
        else:
            H, W = self.grid
            y = int(rng.integers(0, H - self.crop + 1))
            x = int(rng.integers(0, W))  # any lon start: periodic wraparound
            window = (y, x, self.crop, self.crop)
        a = self.A.read(ia, window)
        b = self.B.read(ib, window)
        return {
            "A": a,
            "B": b,
            "A_mean": self.A.mean,
            "A_std": self.A.std,
            "B_mean": self.B.mean,
            "B_std": self.B.std,
            "A_paths": f"{self.A.files[self.A._index[ia % len(self.A)][0]]}#t{self.A._index[ia % len(self.A)][1]}",
            "B_paths": f"{self.B.files[self.B._index[ib % len(self.B)][0]]}#t{self.B._index[ib % len(self.B)][1]}",
        }
