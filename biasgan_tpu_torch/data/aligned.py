"""The 'aligned' (paired) dataset: one image holds A|B side by side, split
in half, the same transform draws for both (the reference's
data/aligned_dataset.py). Counterpart of ``biasgan_tpu/data/aligned.py``:
the same files, draws and arrays. PIL is imported when a sample is read."""

from __future__ import annotations

import os
from typing import Dict

from biasgan_tpu_torch.data.image_folder import make_dataset
from biasgan_tpu_torch.data.transforms import get_params, sample_rng, transform_image
from biasgan_tpu_torch.registry import register_dataset


@register_dataset("aligned")
class AlignedDataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.dir_AB = os.path.join(cfg.dataroot, cfg.phase)
        self.AB_paths = make_dataset(self.dir_AB, cfg.max_dataset_size)
        if cfg.load_size < cfg.crop_size:
            raise ValueError(f"--crop_size {cfg.crop_size} must be <= --load_size "
                             f"{cfg.load_size}")
        self.input_nc = cfg.output_nc if cfg.direction == "BtoA" else cfg.input_nc
        self.output_nc = cfg.input_nc if cfg.direction == "BtoA" else cfg.output_nc
        self.seed = cfg.seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.AB_paths)

    def __getitem__(self, index: int) -> Dict:
        from PIL import Image

        path = self.AB_paths[index]
        AB = Image.open(path).convert("RGB")
        w, h = AB.size
        w2 = w // 2
        A = AB.crop((0, 0, w2, h))
        B = AB.crop((w2, 0, w, h))
        rng = sample_rng(self.seed, self.epoch, index)
        params = get_params(self.cfg, A.size, rng)
        a = transform_image(A, self.cfg, params, grayscale=self.input_nc == 1)
        b = transform_image(B, self.cfg, params, grayscale=self.output_nc == 1)
        return {"A": a, "B": b, "A_paths": path, "B_paths": path}
