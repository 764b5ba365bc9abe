"""Data layer: name-keyed dataset registry + batching loader.

Counterpart of ``biasgan_tpu/data/__init__.py`` (the reference's
``create_dataset(opt)`` -> iterable of dicts {'A','B','A_paths','B_paths'}),
numpy-only: batches are NHWC float32 numpy arrays that the CLIs move to
their device, read in the consumer's thread or, with --num_threads N, by a
pool of N threads ahead of it. The datasets are the JAX package's five: 'aligned',
'unaligned', 'single' (image folders, read with PIL), 'climate' and
'synthetic'. The
held-out split (--val_split) is the JAX package's (``_Subset``), and a
data-parallel rank's loader yields its slice of every global batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from biasgan_tpu_torch.data import (  # noqa: F401 (registers them)
    aligned,
    climate,
    single,
    synthetic,
    unaligned,
)


class DataLoader:
    """Shuffling, fixed-shape batching loader (reference
    CustomDatasetDataLoader semantics: shuffle unless --serial_batches,
    cap at --max_dataset_size). With --num_threads 0 (the test-time
    default) samples are read in the consumer's thread; with N > 0 a
    producer thread maps the sample reads over a pool of N worker threads
    and keeps ``prefetch_batches`` collated batches ahead of the consumer
    (JAX ``data/__init__.py:70-110``), so host reads overlap the device's
    step. Each sample draws from (seed, epoch, index), so the batches are
    bitwise those of 0. A worker's exception is raised in the consumer; a
    consumer that stops early (``break``, or the iterator dropped) sets the
    stop event, and the producer exits at its next batch and is joined.

    ``rank`` of ``ranks`` (data parallelism): each global batch of
    --batch_size samples, in the one-device loader's order, is cut into
    ``ranks`` contiguous slices, and this loader reads and yields slice
    ``rank`` only (JAX ``shard_batch``: ``P("data")`` on the leading
    axis). ``num_samples`` and ``len`` stay the global ones."""

    def __init__(self, dataset, cfg, rank: int = 0, ranks: int = 1):
        if cfg.batch_size % ranks:
            raise ValueError(f"--batch_size {cfg.batch_size} (the global batch) does not "
                             f"split evenly over --data_mesh {ranks} ranks")
        self.dataset = dataset
        self.rank, self.ranks = rank, ranks
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
        self.num_threads = max(int(getattr(cfg, "num_threads", 0)), 0)
        self.prefetch_batches = 2

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
        local = self.batch_size // self.ranks
        nb = len(self)

        def batch_indices(b: int) -> List[int]:
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            return [int(i) for i in idx[self.rank * local : (self.rank + 1) * local]]

        if self.num_threads == 0 or nb <= 1:
            for b in range(nb):
                yield _collate([self.dataset[i] for i in batch_indices(b)])
        else:
            yield from self._threaded(nb, batch_indices)
        self.epoch += 1

    def _threaded(self, nb: int, batch_indices) -> Iterator[Dict[str, Any]]:
        """The ``nb`` batches read by a producer thread over a pool of
        --num_threads workers, ``prefetch_batches`` ahead."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        done = object()
        stop = threading.Event()  # set when the consumer stops iterating

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, batch_indices(b)))
                        if not put(_collate(samples)):
                            return
                put(done)
            except BaseException as e:  # the consumer raises it
                put(e)

        producer = threading.Thread(target=produce, name="loader-producer", daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            producer.join()


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key.endswith("_paths"):
            out[key] = [v for s in vals for v in (s if isinstance(s, list) else [s])]
        else:
            out[key] = np.stack(vals).astype(np.float32)
    return out


class _Subset:
    """Contiguous index-range view of a dataset (train/val splits). Samples
    keep their global index, so per-sample draws (seed, epoch, index) and
    synthetic field identities do not depend on the split."""

    def __init__(self, base, start: int, count: int):
        self._base, self._start, self._count = base, start, count

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, i: int):
        return self._base[self._start + int(i)]

    @property
    def epoch(self):
        return getattr(self._base, "epoch", 0)

    @epoch.setter
    def epoch(self, e):
        self._base.epoch = e


def create_dataset(cfg, split: Optional[str] = None, rank: int = 0,
                   ranks: int = 1) -> DataLoader:
    """Build the loader over the dataset --dataset_mode names. ``split``:
    None = the whole dataset; 'train' / 'val' = the first n - val_split /
    the last val_split samples (--val_split; the held-out tail, for climate
    data the most recent frames). ``rank`` of ``ranks``: a data-parallel
    rank's loader (``DataLoader``)."""
    from biasgan_tpu_torch.registry import get_dataset

    dataset = get_dataset(cfg.dataset_mode)(cfg)
    vs = int(getattr(cfg, "val_split", 0) or 0)
    if split is not None:
        # a typo'd split, or a split without --val_split, would otherwise
        # return the whole dataset, and "held-out" metrics would be of
        # training data
        if split not in ("train", "val"):
            raise ValueError(f"unknown split {split!r} (train|val)")
        if vs <= 0:
            raise ValueError(f"split={split!r} requested but --val_split is not set")
        n = len(dataset)
        if vs >= n:
            raise ValueError(f"--val_split {vs} must be smaller than the dataset ({n})")
        if split == "val" and vs < cfg.batch_size:
            # the loader drops partial batches: a split smaller than a batch
            # would yield no batch, and no held-out metric nor plateau decay
            raise ValueError(f"--val_split {vs} must be >= --batch_size {cfg.batch_size} "
                             "(the val loader yields full batches)")
        dataset = _Subset(dataset, 0, n - vs) if split == "train" else _Subset(dataset, n - vs, vs)
    if cfg.verbose:
        print(f"dataset [{type(dataset).__name__}] was created ({len(dataset)} samples)")
    return DataLoader(dataset, cfg, rank, ranks)
