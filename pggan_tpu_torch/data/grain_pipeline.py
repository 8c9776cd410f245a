"""The grain-backed batch stream (`data_backend_impl: grain`) — the
counterpart of `pggan_tpu/data/grain_pipeline.py`.

The same `grain.MapDataset` graph as the JAX package's: a shuffle seeded
alike on every rank, truncated to a multiple of the ranks, this rank's
every `num_replicas`-th element, endless epochs (`.repeat()`), one
augmentation seed per record keyed by its position in the rank's stream,
drop-remainder batches, and `start_batch` as a lazy slice (a pure function
of the batch index, so a resume loads nothing it skips). So both packages
draw the same batches from the same dataset.

The iterator contract is `data/pipeline.py:DataPipeline`'s: uint8
[B, R, R, 3] batches on the trainer's device, through pinned memory and a
`non_blocking` copy on a card (in place of the JAX package's `shard_fn`).
`grain` is imported when this module is, and only the trainer's grain
branch imports it.
"""

from __future__ import annotations

import gc
from typing import Iterator, Optional, Sequence

import grain
import numpy as np
import torch

_MOD = 2**31 - 1


class GrainPipeline:
    def __init__(self, dataset, batch_size: int, *,
                 indices: Optional[Sequence[int]] = None,
                 num_workers: int = 8, prefetch_depth: int = 2,
                 seed: int = 42, rank: int = 0, num_replicas: int = 1,
                 start_batch: int = 0, device="cpu"):
        """`batch_size` is this rank's batch; `num_workers` grain's reader
        threads; `prefetch_depth` batches of records read ahead."""
        rank, num_replicas = int(rank), int(num_replicas)
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} outside [0, {num_replicas})")
        self.device = torch.device(device)
        indices = list(indices) if indices is not None else list(range(len(dataset)))
        if len(indices) < batch_size * num_replicas:      # small datasets: repeat
            indices = indices * -(-batch_size * num_replicas // len(indices))
        rec_base = (seed + 1 + 1_000_003 * rank) % _MOD
        n_even = len(indices) - len(indices) % num_replicas   # equal epochs a rank

        def load(args):
            index, rec_seed = args
            return dataset.get(int(index), np.random.RandomState(int(rec_seed)))

        base = (grain.MapDataset.source(indices)
                .seed(seed)                                 # the same on every rank
                .shuffle()[:n_even][rank::num_replicas]
                .repeat()
                .map_with_index(lambda i, idx: (idx, (rec_base * 48271 + i) % _MOD))
                .map(load)
                .batch(batch_size, drop_remainder=True))
        if start_batch:
            base = base[int(start_batch):]
        self._iter = iter(base.to_iter_dataset(grain.ReadOptions(
            num_threads=max(1, num_workers),
            prefetch_buffer_size=max(1, prefetch_depth) * batch_size)))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> torch.Tensor:
        host = torch.from_numpy(np.asarray(next(self._iter)))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def close(self) -> None:
        """Release grain's reader threads and prefetch buffers now rather
        than at exit."""
        it, self._iter = self._iter, None
        if it is not None:
            close = getattr(it, "close", None) or getattr(it, "stop", None)
            if callable(close):
                close()
            del it
        gc.collect()                # the reader threads referenced only by `it`

    def __enter__(self) -> "GrainPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
