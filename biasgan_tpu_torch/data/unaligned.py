"""The 'unaligned' (unpaired) dataset: <phase>A/ and <phase>B/ directories,
a random B index unless --serial_batches, len = max(lenA, lenB) (the
reference's data/unaligned_dataset.py). Counterpart of
``biasgan_tpu/data/unaligned.py``: the same files, draws and arrays. PIL
is imported when a sample is read."""

from __future__ import annotations

import os
from typing import Dict

from biasgan_tpu_torch.data.image_folder import make_dataset
from biasgan_tpu_torch.data.transforms import sample_rng, transform_image
from biasgan_tpu_torch.registry import register_dataset


@register_dataset("unaligned")
class UnalignedDataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.dir_A = os.path.join(cfg.dataroot, cfg.phase + "A")
        self.dir_B = os.path.join(cfg.dataroot, cfg.phase + "B")
        self.A_paths = make_dataset(self.dir_A, cfg.max_dataset_size)
        self.B_paths = make_dataset(self.dir_B, cfg.max_dataset_size)
        btoa = cfg.direction == "BtoA"
        self.input_nc = cfg.output_nc if btoa else cfg.input_nc
        self.output_nc = cfg.input_nc if btoa else cfg.output_nc
        self.epoch = 0

    def __len__(self) -> int:
        return max(len(self.A_paths), len(self.B_paths))

    def __getitem__(self, index: int) -> Dict:
        from PIL import Image

        # one generator per sample: the B index, then A's crop and flip
        # coin, then B's
        rng = sample_rng(self.cfg.seed, self.epoch, index)
        a_path = self.A_paths[index % len(self.A_paths)]
        if self.cfg.serial_batches:
            b_index = index % len(self.B_paths)
        else:
            b_index = int(rng.integers(0, len(self.B_paths)))
        b_path = self.B_paths[b_index]
        a = transform_image(Image.open(a_path), self.cfg, None,
                            grayscale=self.input_nc == 1, rng=rng)
        b = transform_image(Image.open(b_path), self.cfg, None,
                            grayscale=self.output_nc == 1, rng=rng)
        return {"A": a, "B": b, "A_paths": a_path, "B_paths": b_path}
