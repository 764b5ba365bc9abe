"""Climate ingestion of the PyTorch port (biasgan_tpu_torch/data): the same
samples and statistics as the JAX package's reader on an HDF5 store, and a
NetCDF-3 store read through scipy on a host without h5py."""

import os
import sys

import numpy as np
import pytest

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.data import create_dataset as jax_create_dataset
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.data import create_dataset

T, H, W = 3, 9, 16


def _args(root, *extra):
    return ["--model", "pix2pix", "--dataset_mode", "climate",
            "--dataroot", str(root), "--full_field", *extra]


def _netcdf3_store(root):
    from scipy.io import netcdf_file

    rng = np.random.default_rng(0)
    data = {}
    for side in ("A", "B"):
        d = root / ("test" + side)
        os.makedirs(d)
        arrs = {v: rng.normal(size=(T, H, W)).astype(np.float32) for v in ("u", "v")}
        with netcdf_file(d / "f.nc", "w") as f:
            f.createDimension("time", T)
            f.createDimension("lat", H)
            f.createDimension("lon", W)
            for name, a in arrs.items():
                f.createVariable(name, "f4", ("time", "lat", "lon"))[:] = a
        data[side] = arrs
    return data


def test_netcdf3_reads_without_h5py(tmp_path, monkeypatch):
    data = _netcdf3_store(tmp_path)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py -> ImportError
    batches = list(create_dataset(parse_config(_args(tmp_path))))
    assert len(batches) == T
    for t, b in enumerate(batches):
        want = np.stack([data["A"]["u"][t], data["A"]["v"][t]], axis=-1)[None]
        np.testing.assert_array_equal(b["A"], want)
        assert b["A_mean"].shape == (1, 2)
    allu = data["B"]["u"].astype(np.float64)
    np.testing.assert_allclose(batches[0]["B_mean"][0, 0], allu.mean(), rtol=1e-5)
    np.testing.assert_allclose(batches[0]["B_std"][0, 0], allu.std(), rtol=1e-5)


def test_hdf5_without_h5py_names_the_missing_package(tmp_path, monkeypatch):
    import h5py

    d = tmp_path / "testA"
    os.makedirs(d)
    with h5py.File(d / "x.h5", "w") as f:
        f["t2m"] = np.zeros((H, W), np.float32)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(OSError, match="h5py"):
        create_dataset(parse_config(_args(tmp_path)))


@pytest.mark.parametrize("crop", [False, True])
def test_hdf5_samples_match_jax_reader(tmp_path, crop):
    """Contiguous HDF5 (the memmap fast path): same samples, paths and
    stats as the JAX reader, whole grids and periodic-longitude crops."""
    import h5py

    rng = np.random.default_rng(1)
    for side in ("A", "B"):
        d = tmp_path / ("test" + side)
        os.makedirs(d)
        with h5py.File(d / "x.h5", "w") as f:
            f["t2m"] = rng.normal(280, 10, (T, H, W)).astype(np.float32)
            f["tp"] = rng.gamma(2.0, 1.0, (T, H, W)).astype(np.float32)
    args = _args(tmp_path) if not crop else [
        a for a in _args(tmp_path) if a != "--full_field"
    ] + ["--crop_size", "8", "--preprocess", "crop", "--no-serial_batches"]
    got = list(create_dataset(parse_config(args)))
    want = list(jax_create_dataset(jax_parse_config(args, train=False)))
    assert len(got) == len(want) == T
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k.endswith("_paths"):
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], w[k])
