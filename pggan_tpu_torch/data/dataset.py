"""Training data of the port — the counterpart of the parts of
`pggan_tpu/data/` the trainer needs on one card:

  * `SyntheticDataset` (`dataset.py:233-253`): a fixed random image per
    index, no filesystem;
  * `split_dataset` (`dataset.py:334-341`): the 70/30 index split;
  * `BatchIterator`: uint8 batches [B, R, R, 3] on the step's device, drawn
    in the index and seed order of `DataPipeline._producer`
    (`pipeline.py:134-198`) for one rank: a permutation per epoch from
    `RandomState(seed)`, drop_last, one augmentation seed per sample from
    `RandomState(seed + 1)`, and a `start_batch` fast-forward that advances
    both streams without loading an image, so a resumed run continues the
    stream where the interrupted one stopped.

One thread, no prefetch. Folder datasets, the threaded and native loaders
and the device-resident cache are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image


class SyntheticDataset:
    """Deterministic random images: index i is an 8×8 random image seeded
    by i, resized bilinearly to the scale's resolution."""

    def __init__(self, size: int = 4096, scale_index: int = 0):
        self.size = size
        self.resolution = 2 ** (scale_index + 2)

    def __len__(self) -> int:
        return self.size

    def get(self, index: int, rng: np.random.RandomState) -> np.ndarray:
        r = np.random.RandomState(index % self.size)
        base = r.randint(0, 256, (8, 8, 3), dtype=np.uint8)
        return np.asarray(Image.fromarray(base).resize(
            (self.resolution, self.resolution), Image.BILINEAR), dtype=np.uint8)


def split_dataset(n: int, train_frac: float = 0.7, seed: int = 42
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """70/30 random split of indices (`round` for the train count)."""
    n_train = int(round(n * train_frac))
    perm = np.random.RandomState(seed).permutation(n)
    return perm[:n_train], perm[n_train:]


def build_dataset(cfg, scale_index: int) -> SyntheticDataset:
    """`data_backend`: 'synthetic', or 'auto' without an existing dataset
    root. Folder datasets raise until they are ported."""
    backend = str(cfg.data_backend)
    roots = list(cfg.dataset_root_list or [])
    if backend == "auto":
        backend = "folder" if any(os.path.isdir(r) for r in roots) else "synthetic"
    if backend == "synthetic":
        return SyntheticDataset(int(cfg.synthetic_dataset_size), scale_index)
    if backend == "folder":
        raise NotImplementedError(
            "folder datasets are not ported to pggan_tpu_torch yet (ROADMAP.md "
            "queue 1); use data_backend: synthetic")
    raise ValueError(f"unknown data backend {backend!r}")


class BatchIterator:
    """Endless uint8 batches of `batch_size` images on `device`."""

    def __init__(self, dataset, batch_size: int, *,
                 indices: Optional[Sequence[int]] = None, seed: int = 42,
                 start_batch: int = 0, device="cpu"):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        if len(indices) < self.batch_size:
            # small datasets: sample with replacement rather than starve
            indices = np.tile(indices, -(-self.batch_size // len(indices)))
        self.indices = indices
        self.seed = int(seed)
        self.start_batch = max(0, int(start_batch))
        self.device = torch.device(device)
        self._stream = self._batches()

    def _draws(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(dataset indices, augmentation seeds) of every batch, in order."""
        rng_master = np.random.RandomState(self.seed)
        rng_aug = np.random.RandomState((self.seed + 1) % (2**31 - 1))
        b_size = self.batch_size
        while True:
            order = rng_master.permutation(len(self.indices))
            for b in range(max(len(order) // b_size, 1)):       # drop_last
                sel = order[b * b_size:(b + 1) * b_size]
                if len(sel) < b_size:
                    sel = np.concatenate([sel, order[:b_size - len(sel)]])
                idxs = self.indices[sel]
                yield idxs, rng_aug.randint(0, 2**31 - 1, size=len(idxs))

    def _batches(self) -> Iterator[torch.Tensor]:
        draws = self._draws()
        for _ in range(self.start_batch):
            next(draws)
        for idxs, seeds in draws:
            batch = np.stack([self.dataset.get(int(i), np.random.RandomState(int(s)))
                              for i, s in zip(idxs, seeds)])
            yield torch.from_numpy(batch).to(self.device)

    def __iter__(self) -> "BatchIterator":
        return self

    def __next__(self) -> torch.Tensor:
        return next(self._stream)
