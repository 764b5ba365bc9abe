"""The 'single' dataset: A images only, from --dataroot itself, for
applying a generator at test time (the reference's
data/single_dataset.py). Counterpart of ``biasgan_tpu/data/single.py``:
the same files, draws and arrays. PIL is imported when a sample is read."""

from __future__ import annotations

from typing import Dict

from biasgan_tpu_torch.data.image_folder import make_dataset
from biasgan_tpu_torch.data.transforms import sample_rng, transform_image
from biasgan_tpu_torch.registry import register_dataset


@register_dataset("single")
class SingleDataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.A_paths = make_dataset(cfg.dataroot, cfg.max_dataset_size)
        self.input_nc = cfg.output_nc if cfg.direction == "BtoA" else cfg.input_nc
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.A_paths)

    def __getitem__(self, index: int) -> Dict:
        from PIL import Image

        path = self.A_paths[index]
        rng = sample_rng(self.cfg.seed, self.epoch, index)
        a = transform_image(Image.open(path), self.cfg, None,
                            grayscale=self.input_nc == 1, rng=rng)
        return {"A": a, "A_paths": path}
