"""Data layer: name-keyed dataset registry + batching loader.

Counterpart of ``biasgan_tpu/data/__init__.py`` (the reference's
``create_dataset(opt)`` -> iterable of dicts {'A','B','A_paths','B_paths'}),
numpy-only: batches are NHWC float32 numpy arrays that the CLIs move to
their device. The datasets registered so far are 'aligned', 'climate' and
'synthetic'; the other image datasets and the train/val split arrive with
later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np

from biasgan_tpu_torch.data import aligned, climate, synthetic  # noqa: F401 (registers them)


class DataLoader:
    """Shuffling, fixed-shape batching loader (reference
    CustomDatasetDataLoader semantics: shuffle unless --serial_batches,
    cap at --max_dataset_size). Samples are read in the consumer's thread:
    the reference's test options pin its worker count to 0, and the
    threaded reader of training (--num_threads) is not ported yet."""

    def __init__(self, dataset, cfg):
        self.dataset = dataset
        self.batch_size = cfg.batch_size
        self.shuffle = not cfg.serial_batches
        n = len(dataset)
        if cfg.max_dataset_size and cfg.max_dataset_size > 0:
            n = min(n, cfg.max_dataset_size)
        self.num_samples = n
        self.seed = cfg.seed
        self.epoch = 0
        # fixed batch shapes: drop ragged tail when batching for training
        self.drop_last = cfg.batch_size > 1

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        # datasets derive per-sample RNG from (seed, epoch, index)
        # (transforms.sample_rng): reproducible under --seed, varying per
        # epoch
        self.dataset.epoch = self.epoch
        order = np.arange(self.num_samples)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            yield _collate([self.dataset[int(i)] for i in idx])
        self.epoch += 1


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key.endswith("_paths"):
            out[key] = [v for s in vals for v in (s if isinstance(s, list) else [s])]
        else:
            out[key] = np.stack(vals).astype(np.float32)
    return out


def create_dataset(cfg) -> DataLoader:
    """Build the loader over the dataset --dataset_mode names."""
    from biasgan_tpu_torch.registry import get_dataset

    dataset = get_dataset(cfg.dataset_mode)(cfg)
    if cfg.verbose:
        print(f"dataset [{type(dataset).__name__}] was created ({len(dataset)} samples)")
    return DataLoader(dataset, cfg)
