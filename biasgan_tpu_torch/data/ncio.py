"""File IO shim: HDF5 / NetCDF-4 via h5py, classic NetCDF-3 via scipy.

Counterpart of ``biasgan_tpu/data/ncio.py``. NetCDF-4 files ARE HDF5, so
h5py reads them directly; classic NetCDF-3 is a different on-disk format
h5py refuses, so we fall back to ``scipy.io.netcdf_file`` (pure-python,
mmap'd) behind the same minimal interface the climate dataset uses:
``f[name] -> dataset`` with ``.ndim``, ``.shape`` and numpy-style slicing,
plus ``close()``.

h5py is optional here: a host without it reads NetCDF-3 through scipy, and
refuses an HDF5 file with an error that names the missing package.
"""

from __future__ import annotations

import threading
import warnings
from typing import List

import numpy as np


def h5py_module():
    """The h5py module, or None when this host does not have it."""
    try:
        import h5py
    except ImportError:
        return None
    return h5py


class _NC3Dataset:
    """netcdf_variable wrapper with h5py-Dataset-shaped access."""

    def __init__(self, var):
        self._var = var
        self.shape = tuple(var.shape)
        self.ndim = len(self.shape)

    def __getitem__(self, idx):
        # copy out of the mmap so handles can close independently of arrays
        # (np.asarray on a view is a no-op; force the copy)
        return np.array(self._var[idx], copy=True)

    def __array__(self, dtype=None, copy=None):
        a = np.array(self._var[...], copy=True)
        return a.astype(dtype) if dtype is not None else a


class _NC3File:
    """scipy.io.netcdf_file with h5py-File-shaped access. The threaded
    loader's workers share one: the variable lookups and ``close`` hold
    its lock; the reads slice scipy's mmap, which concurrent readers may
    do."""

    def __init__(self, path: str, mmap: bool = True):
        from scipy.io import netcdf_file

        # mmap=False for short-lived discovery handles: scipy refuses to
        # close an mmap'd file while variable refs are alive and emits a
        # RuntimeWarning from __del__ instead
        self._f = netcdf_file(path, "r", mmap=mmap)
        self._lock = threading.Lock()

    def __getitem__(self, name: str) -> _NC3Dataset:
        with self._lock:
            return _NC3Dataset(self._f.variables[name])

    def field_names(self) -> List[str]:
        return sorted(
            name
            for name, var in self._f.variables.items()
            if len(var.shape) in (2, 3)
        )

    def close(self) -> None:
        # Our accessors COPY out of the mmap on every read (__getitem__
        # above), so a deferred unmap when variable refs are still alive is
        # harmless — silence scipy's RuntimeWarning about exactly that.
        with self._lock, warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="Cannot close a netcdf_file",
                category=RuntimeWarning,
            )
            self._f.close()


def open_field_file(path: str, mmap: bool = True):
    """Open with h5py when the host has it; fall back to the NetCDF-3 reader
    when h5py is missing or rejects the container (classic netCDF is not
    HDF5)."""
    h5py = h5py_module()
    if h5py is None:
        try:
            return _NC3File(path, mmap=mmap)
        except TypeError as e:  # scipy: "... is not a valid NetCDF 3 file"
            raise OSError(
                f"{path}: not a NetCDF-3 file, and h5py (needed for HDF5 / "
                "NetCDF-4) is not installed"
            ) from e
    try:
        return h5py.File(path, "r")
    except OSError:
        return _NC3File(path, mmap=mmap)


def discover_variables(path: str) -> List[str]:
    """Sorted names of all 2-D/3-D datasets in the file (either container)."""
    f = open_field_file(path, mmap=False)
    try:
        if isinstance(f, _NC3File):
            return f.field_names()
        h5py = h5py_module()
        out: List[str] = []

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset) and obj.ndim in (2, 3):
                out.append(name)

        f.visititems(visit)
        return sorted(out)
    finally:
        f.close()
