"""The synthetic training images and their order, worked out from the seed
as the trainer's `synthetic` data backend defines them (the reference
package's synthetic fallback; `pggan_tpu/data/dataset.py:SyntheticDataset`
and `DataPipeline`'s draws):

- image i of a set of `size`: an 8×8 RGB image of uint8 values drawn by
  `RandomState(i % size)`, resized bilinearly (PIL) to the resolution;
- the training split: the first round(0.7·size) of
  `RandomState(seed).permutation(size)`;
- the batches: each epoch a `RandomState(seed + scale)` permutation of the
  split, cut into whole batches in order.

Augmentation draws do not touch synthetic images.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
from PIL import Image


def synthetic_image(index: int, size: int, resolution: int) -> np.ndarray:
    base = np.random.RandomState(index % size).randint(0, 256, (8, 8, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(base).resize((resolution, resolution),
                                                   Image.BILINEAR), dtype=np.uint8)


def _batch_indices(seed: int, scale: int, size: int, batch: int) -> Iterator[np.ndarray]:
    split = np.random.RandomState(seed).permutation(size)[:int(round(size * 0.7))]
    order_rng = np.random.RandomState(seed + scale)
    while True:
        order = order_rng.permutation(len(split))
        for b in range(max(len(order) // batch, 1)):
            yield split[order[b * batch:(b + 1) * batch]]


def train_batches(seed: int, scale: int, size: int, batch: int, first: int,
                  count: int) -> List[np.ndarray]:
    """uint8 [batch, R, R, 3] batches number first .. first+count-1 of the
    stream (0-based)."""
    resolution = 4 * 2 ** scale
    out = []
    for position, idxs in enumerate(_batch_indices(seed, scale, size, batch)):
        if position >= first + count:
            break
        if position >= first:
            out.append(np.stack([synthetic_image(int(i), size, resolution) for i in idxs]))
    return out
