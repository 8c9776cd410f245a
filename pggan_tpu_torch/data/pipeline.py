"""The prefetching, endless batch stream of the trainer — the counterpart of
`pggan_tpu/data/pipeline.py:DataPipeline`.

  * a producer thread draws each batch's dataset indices and augmentation
    seeds, and a pool of `num_workers` threads loads its images (the native
    loader's ctypes calls release the GIL, and so does PIL while it decodes
    and resizes, though not between its jitter ops);
  * batches are uint8 [B, R, R, 3], put on the step's device by the
    producer thread while the step before runs, into a queue of
    `prefetch_depth` batches;
  * one permutation an epoch, drop_last, and under `num_replicas` ranks
    round-robin shards of that shared permutation;
  * `start_batch` fast-forwards both random streams without loading an
    image, so a resumed run continues the stream where the interrupted one
    stopped;
  * with `assemble_fn` (the device cache, `data/device_cache.py`) the
    producer hands each batch's (indices, seeds) to it instead of the
    workers: the same draws, so the same stream, assembled on the card.

The index and seed draws are the JAX package's, number for number, so both
packages feed a step the same images.

`InfiniteSampler` is StyleGAN2's streaming index sampler, which
`DataPipeline` does not use (as in the JAX package).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

_JOIN_S = 10.0


class InfiniteSampler:
    """An endless stream of dataset indices, StyleGAN2's InfiniteSampler
    (`pggan_tpu/data/pipeline.py:30-76`), numpy only. With `shuffle`, the
    order starts as a `RandomState(seed)` permutation, and after each
    position is visited it is swapped with one of the `rint(size ·
    window_size)` positions up to it (none when that window is under 2), so
    the order keeps mixing without a full reshuffle. Rank `rank` of
    `num_replicas` yields the positions whose count is `rank` modulo
    `num_replicas`, so the ranks' streams partition each pass. The index
    stream is the JAX package's, number for number."""

    def __init__(self, dataset_size: int, *, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        if dataset_size <= 0 or num_replicas <= 0:
            raise ValueError(f"dataset_size {dataset_size} and num_replicas {num_replicas} "
                             f"must be positive")
        if not 0 <= rank < num_replicas or not 0 <= window_size <= 1:
            raise ValueError(f"rank {rank} outside [0, {num_replicas}) or window_size "
                             f"{window_size} outside [0, 1]")
        self.dataset_size = int(dataset_size)
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


class DataPipeline:
    def __init__(self, dataset, batch_size: int, *,
                 indices: Optional[Sequence[int]] = None,
                 num_workers: int = 8, prefetch_depth: int = 2,
                 seed: int = 42, rank: int = 0, num_replicas: int = 1,
                 start_batch: int = 0, device="cpu", assemble_fn=None):
        """`batch_size` is this rank's batch. The permutation stream is
        seeded by `seed` on every rank, so the ranks' shards are disjoint
        pieces of one epoch; the augmentation stream by
        seed + 1 + 1_000_003·rank, so no two ranks jitter alike.

        `assemble_fn(idxs, seeds)`, when given, makes each batch from the
        drawn dataset indices and augmentation seeds, on the producer
        thread, in place of the workers' decode and `_to_device`
        (`pggan_tpu/data/pipeline.py:169-177`). It launches on that
        thread's current stream: with `DeviceDataCache.assemble`, the
        default stream of the card, which the train step runs on too (PyTorch
        gives every thread the legacy default stream unless it sets
        another), so CUDA orders the assembly before every kernel that reads
        the batch, and the batch's memory is allocated and freed on the
        step's stream."""
        if not 0 <= int(rank) < int(num_replicas):
            raise ValueError(f"rank {rank} outside [0, {num_replicas})")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.rank = int(rank)
        self.num_replicas = int(num_replicas)
        self.indices = np.asarray(indices if indices is not None
                                  else np.arange(len(dataset)))
        if len(self.indices) < self.batch_size * self.num_replicas:
            # small datasets: sample with replacement rather than starve
            reps = -(-self.batch_size * self.num_replicas // len(self.indices))
            self.indices = np.tile(self.indices, reps)
        self.num_workers = max(1, int(num_workers))
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.seed = int(seed)
        self.start_batch = max(0, int(start_batch))
        self.device = torch.device(device)
        self.assemble_fn = assemble_fn
        self._queue: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                        thread_name_prefix="pggan-data")
        self._thread = threading.Thread(target=self._producer, daemon=True,
                                        name="pggan-data-producer")
        self._thread.start()

    # -- producer ------------------------------------------------------------
    def _draws(self) -> Iterator:
        """(dataset indices, augmentation seeds) of every batch, in order
        (`pggan_tpu/data/pipeline.py:134-198`)."""
        rng_master = np.random.RandomState(self.seed)
        rng_aug = np.random.RandomState(
            (self.seed + 1 + 1_000_003 * self.rank) % (2**31 - 1))
        while True:
            order = rng_master.permutation(len(self.indices))
            # equal shards, so no rank runs ahead into the next epoch
            order = order[:len(order) - len(order) % self.num_replicas]
            order = order[self.rank::self.num_replicas]
            for b in range(max(len(order) // self.batch_size, 1)):    # drop_last
                sel = order[b * self.batch_size:(b + 1) * self.batch_size]
                if len(sel) < self.batch_size:          # tiny dataset
                    sel = np.concatenate([sel, order[:self.batch_size - len(sel)]])
                idxs = self.indices[sel]
                yield idxs, rng_aug.randint(0, 2**31 - 1, size=len(idxs))

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        """The batch on the step's device. On a card: a pinned host copy,
        then an asynchronous copy to the card on this thread's current
        stream, which is the device's default stream, the one the train
        step runs on; so CUDA orders the copy before every kernel that
        reads the batch, and no cross-stream wait is needed. A side stream
        would let the copy overlap the step, but it moves about 3 MB (256²,
        batch 16) against a step of tens of milliseconds. The pinned
        buffer is a fresh allocation per batch: PyTorch's pinned-memory
        allocator records an event on the stream of a non_blocking copy
        and does not hand the block out again before that event completes,
        so it is not reused while the copy reads it."""
        host = torch.from_numpy(batch)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def _producer(self) -> None:
        skip = self.start_batch
        for idxs, seeds in self._draws():
            if self._stop.is_set():
                return
            if skip > 0:                # fast-forward: draw, load nothing
                skip -= 1
                continue
            try:
                if self.assemble_fn is not None:
                    batch = self.assemble_fn(idxs, seeds)
                else:
                    futures = [self._pool.submit(self.dataset.get, int(i),
                                                 np.random.RandomState(int(s)))
                               for i, s in zip(idxs, seeds)]
                    batch = self._to_device(np.stack([f.result() for f in futures]))
            except Exception as exc:    # handed to the consumer, raised there
                if not self._stop.is_set():     # else close() cut the batch
                    self._enqueue(exc)
                return
            self._enqueue(batch)

    def _enqueue(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    # -- consumer ------------------------------------------------------------
    def __iter__(self) -> "DataPipeline":
        return self

    def __next__(self) -> torch.Tensor:
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        """Stop the producer and the workers; waits up to _JOIN_S for the
        producer to finish the image loads it started."""
        self._stop.set()
        try:                            # unblock a producer waiting to put
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._thread.join(_JOIN_S)

    def __enter__(self) -> "DataPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
