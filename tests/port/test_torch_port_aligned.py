"""The 'aligned' dataset of the PyTorch port against the JAX package's, on a
few A|B PNGs written to tmp_path: the same seed and epoch give the same
arrays, bit for bit (both read with PIL and transform on the host with
numpy), sample by sample and batch by batch through each package's loader,
for RGB and grayscale sides, AtoB and BtoA, and each resize / crop
preprocess mode."""

import numpy as np
import pytest
from PIL import Image

from biasgan_tpu.config import parse_config as jax_parse_config
from biasgan_tpu.data import create_dataset as jax_create_dataset
from biasgan_tpu_torch.config import parse_config
from biasgan_tpu_torch.data import create_dataset


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("aligned")
    (root / "train").mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(40, 80), (48, 96), (40, 80), (52, 100), (40, 80)]):
        ab = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(ab).save(root / "train" / f"{i:02d}.png")
    return root


@pytest.mark.parametrize("extra", [
    [],
    ["--input_nc", "1", "--direction", "BtoA"],
    ["--preprocess", "crop", "--no_flip"],
    ["--preprocess", "scale_width_and_crop", "--output_nc", "1"],
])
def test_aligned_matches_jax(root, extra):
    argv = ["--model", "pix2pix", "--dataset_mode", "aligned", "--dataroot", str(root),
            "--load_size", "36", "--crop_size", "32", "--batch_size", "2", "--seed", "3",
            *extra]
    cfg = parse_config(argv, train=True)
    assert cfg.load_size == 36 and parse_config([], train=True).load_size == 286
    assert parse_config([]).load_size == 256
    jax_loader, loader = jax_create_dataset(jax_parse_config(argv, train=True)), \
        create_dataset(cfg)
    jd, d = jax_loader.dataset, loader.dataset
    assert len(d) == len(jd) == 5
    for epoch in (0, 1):
        jd.epoch = d.epoch = epoch
        for i in range(len(d)):
            want, got = jd[i], d[i]
            assert got.keys() == want.keys()
            for k in ("A", "B"):
                assert got[k].dtype == np.float32 and got[k].shape[:2] == (32, 32)
                np.testing.assert_array_equal(got[k], want[k])
            assert got["A_paths"] == want["A_paths"]
    batches = list(zip(jax_loader, loader))
    assert len(batches) == 2
    for want, got in batches:
        for k in ("A", "B"):
            np.testing.assert_array_equal(got[k], want[k])
