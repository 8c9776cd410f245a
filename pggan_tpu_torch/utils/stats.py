"""Training statistics across ranks — the counterpart of
`pggan_tpu/utils/stats.py` (the reference's vendored
`torch_utils/training_stats.py`): per-name streaming [num, sum, sum of
squares] counters, `report`, `report0` (rank 0 only), a `Collector` giving
num / mean / std over what was reported since its last update, and
`all_reduce_moments` in place of the JAX package's `psum_moments`: the
local moments of a value summed over the ranks, so the pooled mean is the
mean over every rank's values (summing the values themselves and reporting
that would inflate the mean by the world size).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from pggan_tpu_torch.parallel import mesh

_counters: Dict[str, np.ndarray] = {}   # name → [num, sum, sum_sq] float64


def _accumulate(name: str, moments: np.ndarray) -> None:
    _counters[name] = _counters[name] + moments if name in _counters else moments


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
    return np.asarray(value, dtype=np.float64).ravel()


def report(name: str, value) -> None:
    """Accumulate a scalar or array statistic under `name`."""
    arr = _host(value)
    if arr.size:
        _accumulate(name, np.array([arr.size, arr.sum(), np.square(arr).sum()]))


def report0(name: str, value) -> None:
    """Report only on rank 0 (`training_stats.py:103`)."""
    if mesh.is_master():
        report(name, value)


def all_reduce_moments(value: torch.Tensor) -> torch.Tensor:
    """[num, sum, sum of squares] of `value` (f64, on its device), summed
    over the ranks; feed it to `report_moments`. Every rank must call it."""
    v = value.detach().double().reshape(-1)
    moments = torch.stack([v.new_tensor(float(v.numel())), v.sum(), v.square().sum()])
    if dist.is_initialized():
        dist.all_reduce(moments)
    return moments


def report_moments(name: str, moments) -> None:
    """Accumulate a [num, sum, sum of squares] vector under `name`."""
    m = _host(moments)
    if m.shape != (3,):
        raise ValueError(f"moments must be [num, sum, sum_sq], got shape {m.shape}")
    _accumulate(name, m)


class Collector:
    """A snapshot-and-delta view of the counters (`training_stats.py:113-226`):
    the baseline is taken at construction, and with `keep_previous` (the
    reference's default) an update that saw no new reports keeps the
    previous round's statistics instead of going NaN."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        self._pattern = re.compile(regex)
        self._keep_previous = bool(keep_previous)
        self._deltas: Dict[str, np.ndarray] = {}
        self._snapshot: Dict[str, np.ndarray] = {
            name: moments.copy() for name, moments in _counters.items()
            if self._pattern.fullmatch(name)}

    def update(self) -> None:
        for name, moments in _counters.items():
            if not self._pattern.fullmatch(name):
                continue
            delta = moments - self._snapshot.get(name, np.zeros(3))
            if delta[0] == 0 and self._keep_previous and name in self._deltas:
                continue                   # an idle round keeps the previous stats
            self._deltas[name] = delta
            self._snapshot[name] = moments.copy()

    def names(self):
        return list(self._deltas)

    def num(self, name: str) -> int:
        return int(self._deltas.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        d = self._deltas.get(name)
        if d is None or d[0] == 0:
            return float("nan")
        return float(d[1] / d[0])

    def std(self, name: str) -> float:
        d = self._deltas.get(name)
        if d is None or d[0] == 0 or not np.isfinite(d[1] / d[0]):
            return float("nan")
        if d[0] == 1:
            return 0.0
        mean = d[1] / d[0]
        return float(np.sqrt(max(d[2] / d[0] - mean ** 2, 0.0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"num": self.num(name), "mean": self.mean(name), "std": self.std(name)}
                for name in self.names()}


def reset() -> None:
    _counters.clear()
