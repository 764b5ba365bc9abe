"""The threaded loader of the port (--num_threads N, ``data.DataLoader``):
a producer thread over a pool of N workers, two batches ahead, against the
loader reading in the consumer's thread (--num_threads 0) and against the
JAX package's loader (its threaded reader, the training default 4).

Held bitwise over two epochs (each sample draws from (seed, epoch,
index), so thread scheduling cannot move a draw): synthetic fields, crops
of a NetCDF-3 store (read through scipy, the workers sharing its handle
under the reader's lock) and aligned A|B PNGs; a data-parallel rank's
slices too. A consumer that stops mid-epoch leaves no producer thread
alive 2 s later; a worker's exception reaches the consumer; the test-time
config reads with no threads.
"""

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.data import create_dataset as jax_create_dataset
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.data import DataLoader, create_dataset


def _netcdf_store(root):
    from scipy.io import netcdf_file

    rng = np.random.default_rng(0)
    for side in "AB":
        d = root / f"train{side}"
        os.makedirs(d)
        with netcdf_file(d / "f.nc", "w") as f:
            f.createDimension("time", 7)
            f.createDimension("lat", 12)
            f.createDimension("lon", 20)
            for v in ("u", "t2m"):
                f.createVariable(v, "f4", ("time", "lat", "lon"))[:] = rng.normal(
                    size=(7, 12, 20)).astype(np.float32)


def _png_store(root):
    from PIL import Image

    (root / "train").mkdir()
    rng = np.random.default_rng(1)
    for i in range(7):
        ab = rng.integers(0, 256, size=(40, 80, 3), dtype=np.uint8)
        Image.fromarray(ab).save(root / "train" / f"{i:02d}.png")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    nc, png = tmp_path_factory.mktemp("nc"), tmp_path_factory.mktemp("png")
    _netcdf_store(nc)
    _png_store(png)
    return {"netcdf": nc, "png": png}


CASES = {
    "synthetic": lambda r: ["--dataset_mode", "synthetic", "--synthetic_samples", "7",
                            "--crop_size", "16", "--input_nc", "2", "--output_nc", "2"],
    "netcdf": lambda r: ["--dataset_mode", "climate", "--dataroot", str(r["netcdf"]),
                         "--crop_size", "8", "--preprocess", "crop", "--input_nc", "2",
                         "--output_nc", "2"],
    "png": lambda r: ["--dataset_mode", "aligned", "--dataroot", str(r["png"]),
                      "--load_size", "36", "--crop_size", "32"],
}


def _epochs(loader, n=2):
    return [b for _ in range(n) for b in loader]


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), what
        for k in g:
            if k.endswith("_paths"):
                assert g[k] == w[k], (what, i, k)
            else:
                assert g[k].dtype == w[k].dtype, (what, i, k)
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} batch {i} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_threads_give_the_batches_of_none_and_of_jax(roots, name):
    argv = ["--model", "pix2pix", "--batch_size", "3", "--seed", "5"] + CASES[name](roots)
    threaded = create_dataset(parse_config(argv, train=True))
    assert threaded.num_threads == 4  # the JAX training default
    got = _epochs(threaded)
    assert len(got) == 4  # 7 samples at batch 3: two batches an epoch, the tail dropped
    _same(got, _epochs(create_dataset(parse_config(argv + ["--num_threads", "0"],
                                                   train=True))), f"{name}: 4 vs 0 threads")
    _same(got, _epochs(jax_create_dataset(jax_parse_config(argv, train=True))),
          f"{name}: port vs JAX loader")
    # a data-parallel rank's slices, threaded and not
    rank = [create_dataset(parse_config(argv + ["--num_threads", str(t)], train=True),
                           None, 1, 3) for t in (4, 0)]
    _same(*(_epochs(r) for r in rank), f"{name}: rank 1 of 3")


class _Slow:
    """A dataset whose reads take a while (and one that fails)."""

    def __init__(self, n=40, fail=None, delay=0.01):
        self.n, self.fail, self.delay, self.epoch = n, fail, delay, 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        if i == self.fail:
            raise ValueError(f"bad sample {i}")
        return {"A": np.full((2, 2, 1), i, np.float32)}


def _loader(dataset, threads=4):
    cfg = SimpleNamespace(batch_size=2, serial_batches=True, max_dataset_size=-1, seed=0,
                          num_threads=threads)
    return DataLoader(dataset, cfg)


def _producers():
    return [t for t in threading.enumerate() if t.name == "loader-producer" and t.is_alive()]


def test_a_stopped_consumer_leaves_no_producer():
    loader = _loader(_Slow())
    for i, b in enumerate(loader):
        assert b["A"][0, 0, 0, 0] == 2 * i
        if i == 2:
            assert _producers()  # reading ahead
            break
    deadline = time.monotonic() + 2.0
    while _producers() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _producers()
    # the loader starts again from the top
    assert next(iter(loader))["A"][0, 0, 0, 0] == 0
    time.sleep(0.5)
    assert not _producers()


def test_a_worker_error_reaches_the_consumer():
    seen = []
    with pytest.raises(ValueError, match="bad sample 7"):
        for b in _loader(_Slow(fail=7, delay=0.0)):
            seen.append(int(b["A"][0, 0, 0, 0]))
    assert seen == [0, 2, 4]  # the batches before the failing one
    assert not _producers()


def test_test_time_reads_in_the_consumer_thread():
    cfg = parse_config(["--model", "pix2pix", "--dataset_mode", "synthetic"])
    assert cfg.num_threads == 0 and create_dataset(cfg).num_threads == 0


def test_the_reader_opens_each_file_once_under_threads(roots, monkeypatch):
    """The NetCDF reader's handle and accessor caches under concurrent
    reads (more threads than cores, a short switch interval): each file is
    opened once by the readers and every sample is the serial read's."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from biasgan_tpu_torch.data import ncio

    argv = ["--model", "pix2pix", "--batch_size", "3", "--seed", "5"] + CASES["netcdf"](roots)
    want = [create_dataset(parse_config(argv, train=True)).dataset[i] for i in range(7)]
    dataset = create_dataset(parse_config(argv, train=True)).dataset
    for side in (dataset.A, dataset.B):
        side.close()  # every file is opened again by the readers
    opened = []
    real_open = ncio.open_field_file

    def slow_open(path, **kw):  # a wide window for a racing second open
        opened.append(path)
        time.sleep(0.01)
        return real_open(path, **kw)

    monkeypatch.setattr(ncio, "open_field_file", slow_open)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as pool:
            got = list(pool.map(dataset.__getitem__, [i % 7 for i in range(140)]))
    finally:
        sys.setswitchinterval(interval)
    assert sorted(opened) == sorted(dataset.A.files + dataset.B.files)
    for i, sample in enumerate(got):
        for k in ("A", "B"):
            np.testing.assert_array_equal(sample[k], want[i % 7][k], err_msg=f"sample {i} {k}")
