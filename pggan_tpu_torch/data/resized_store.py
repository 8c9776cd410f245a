"""Out-of-core resized-image store: per-scale uint8 memmap, built once — a
copy of `pggan_tpu/data/resized_store.py` (numpy alone).

The cache tier beyond RAM, for a dataset whose resized images at a
scale do not fit the RAM decode cache of `ImageFolderDataset`
(`decode_cache_mb`), as the reference's 37,345 images do from 512² on: the
resized dataset as one `[N, res, res, 3]` uint8 memmap on disk, built ONCE
per (image list, resolution) and then read per draw through the OS page
cache. A memmap row read costs far less than a source decode, and host RAM
stays flat. Later runs reuse the file: the build is resumable and keyed by
a digest of the path list, file sizes, and resolution.

Layout under `store_dir`:
  resized_<res>_<digest>.u8        the [N, res, res, 3] C-order payload
  resized_<res>_<digest>.json      {"n", "resolution", "complete", ...}
  resized_<res>_<digest>.progress  rows completed so far (build resume)
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np


def paths_digest(paths: Sequence[str], resolution: int) -> str:
    """Digest identifying (ordered path list, per-file size, resolution).
    File sizes catch silently-replaced images without decoding anything;
    order matters because store row i must stay aligned with paths[i]."""
    h = hashlib.md5()
    h.update(str(int(resolution)).encode())
    for p in paths:
        try:
            sz = os.path.getsize(p)
        except OSError:
            sz = -1
        h.update(f"{p}\0{sz}\n".encode())
    return h.hexdigest()[:16]


class ResizedStore:
    """Build-once memmap of decoded+resized uint8 images.

    `decode_fn(path) -> [res, res, 3] uint8` supplies rows during the
    build (the dataset passes its `_resize_uncached`).
    """

    PROGRESS_EVERY = 256   # rows between progress-file flushes

    def __init__(self, store_dir: str, paths: Sequence[str], resolution: int,
                 decode_fn: Callable[[str], np.ndarray],
                 *, verbose: bool = False):
        self.paths = list(paths)
        self.resolution = int(resolution)
        self.n = len(self.paths)
        if self.n == 0:
            raise ValueError("empty path list")
        digest = paths_digest(self.paths, self.resolution)
        os.makedirs(store_dir, exist_ok=True)
        base = os.path.join(store_dir, f"resized_{self.resolution}_{digest}")
        self._data_path = base + ".u8"
        self._meta_path = base + ".json"
        self._progress_path = base + ".progress"
        self.nbytes = self.n * self.resolution ** 2 * 3
        if not self._complete():
            self._build(decode_fn, verbose=verbose)
        self._mm = np.memmap(self._data_path, dtype=np.uint8, mode="r",
                             shape=(self.n, self.resolution, self.resolution, 3))

    def _complete(self) -> bool:
        try:
            with open(self._meta_path) as f:
                meta = json.load(f)
            return (bool(meta.get("complete"))
                    and meta.get("n") == self.n
                    and meta.get("resolution") == self.resolution
                    and os.path.getsize(self._data_path) == self.nbytes)
        except (OSError, ValueError):
            return False

    def _build(self, decode_fn, *, verbose: bool):
        start_row = 0
        if os.path.exists(self._data_path) \
                and os.path.getsize(self._data_path) == self.nbytes:
            # interrupted build: resume after the last flushed progress mark
            try:
                with open(self._progress_path) as f:
                    start_row = max(0, min(int(f.read().strip()), self.n))
            except (OSError, ValueError):
                start_row = 0
        mm = np.memmap(self._data_path, dtype=np.uint8, mode="r+"
                       if start_row else "w+",
                       shape=(self.n, self.resolution, self.resolution, 3))
        t0 = time.time()
        if verbose:
            print(f"[resized_store] building {self.n} x {self.resolution}^2 "
                  f"({self.nbytes / 1e9:.1f} GB) at {self._data_path}"
                  + (f", resuming at row {start_row}" if start_row else ""),
                  flush=True)
        for i in range(start_row, self.n):
            mm[i] = decode_fn(self.paths[i])
            if (i + 1) % self.PROGRESS_EVERY == 0:
                mm.flush()
                with open(self._progress_path, "w") as f:
                    f.write(str(i + 1))
                if verbose and (i + 1) % 4096 == 0:
                    rate = (i + 1 - start_row) / (time.time() - t0)
                    eta = (self.n - i - 1) / max(rate, 1e-9)
                    print(f"[resized_store] {i + 1}/{self.n} "
                          f"({rate:.0f} img/s, eta {eta / 60:.1f} min)",
                          flush=True)
        mm.flush()
        del mm
        with open(self._meta_path, "w") as f:
            json.dump({"complete": True, "n": self.n,
                       "resolution": self.resolution,
                       "built_seconds": round(time.time() - t0, 1)}, f)
        try:
            os.remove(self._progress_path)
        except OSError:
            pass
        if verbose:
            print(f"[resized_store] built in {(time.time() - t0) / 60:.1f} min",
                  flush=True)

    def __len__(self) -> int:
        return self.n

    def read(self, index: int) -> np.ndarray:
        """One resized unaugmented image as a fresh in-RAM array (a copy —
        callers may write into their batch buffers)."""
        return np.array(self._mm[index % self.n])
