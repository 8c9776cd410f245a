"""The per-sample augmentation parameters — a copy of
`pggan_tpu/data/augment.py` (numpy only; the port imports nothing of the
JAX package).

A horizontal flip and torchvision's colour-jitter semantics: each factor
drawn from U[max(0, 1-v), 1+v], the hue shift from U[-h, h], the four ops
applied in a shuffled order. The draws come from the sample's own
`RandomState` in a fixed order — the flip, the four factors, then the
shuffle — which is the order the PIL path (`data/dataset.py`) draws in, so
the device cache (`data/device_cache.py`) sees the same flip, factors and
order as the PIL path for the same per-sample seed. Sentinels: -1.0 turns
off brightness, contrast or saturation; -2.0 turns off the hue (and every
factor when the sample is not augmented).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: (brightness, contrast, saturation, hue): the reference's jitter strengths.
DEFAULT_JITTER: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.01)


def draw_augment_params(rng: Optional[np.random.RandomState],
                        jitter: Tuple[float, float, float, float] = DEFAULT_JITTER,
                        augment: bool = True):
    """Returns (flip: int, factors: f32[4], order: i32[4])."""
    if augment and rng is not None:
        flip = 1 if rng.rand() < 0.5 else 0
        b, c, s, h = jitter
        factors = np.array([
            rng.uniform(max(0.0, 1 - b), 1 + b) if b > 0 else -1.0,
            rng.uniform(max(0.0, 1 - c), 1 + c) if c > 0 else -1.0,
            rng.uniform(max(0.0, 1 - s), 1 + s) if s > 0 else -1.0,
            rng.uniform(-h, h) if h > 0 else -2.0,
        ], np.float32)
        order = np.arange(4, dtype=np.int32)
        rng.shuffle(order)
    else:
        flip = 0
        factors = np.full(4, -2.0, np.float32)
        order = np.arange(4, dtype=np.int32)
    return flip, factors, order
