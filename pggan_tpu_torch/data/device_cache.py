"""The device-resident dataset cache — the counterpart of
`pggan_tpu/data/device_cache.py`.

The resized, unaugmented images of a scale are uploaded to the card once
(`DeviceDataCache`), and each training batch is then assembled there from
its dataset indices and per-sample augmentation parameters
(`assemble_batch`): a gather, the horizontal flip and the four colour-jitter
ops in the sample's drawn order. Each batch ships a few hundred bytes of
indices and parameters instead of the decoded pixels, and the host does no
decoding or jitter in the step loop.

The parameters come from `data/augment.py:draw_augment_params` with the
per-sample seeds the pipeline draws (`data/pipeline.py`), so which images,
flips and jitter factors a step sees do not depend on the backend. The
arithmetic is the JAX package's, op for op in f32 (luma .299/.587/.114, a
clamp to [0, 255] after each op, the HSV hue rotation, one rounding at the
end): with augmentation off the batch equals the PIL path's bit for bit;
with it on it differs from JAX's by at most one step of 255 where the f32
sums round apart, and from the PIL path, which rounds to uint8 between
ops, by a few.

The ops are plain torch ops on the device of the data; the JAX package
leaves them to XLA and has no kernel of its own here. One process feeds
one card: there is no mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pggan_tpu_torch.data.augment import DEFAULT_JITTER, draw_augment_params


def _lum(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma of [..., 3] → [...]."""
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _brightness(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x * f, 0.0, 255.0)


def _contrast(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    m = _lum(x).mean(dim=(1, 2), keepdim=True)[..., None]
    return torch.clamp(f * x + (1.0 - f) * m, 0.0, 255.0)


def _saturation(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    g = _lum(x)[..., None]
    return torch.clamp(f * x + (1.0 - f) * g, 0.0, 255.0)


def _select(sector: torch.Tensor, values, default: torch.Tensor) -> torch.Tensor:
    """values[k] where sector == k (k < 5), else default (`jnp.select`)."""
    out = default
    for k in reversed(range(len(values))):
        out = torch.where(sector == k, values[k], out)
    return out


def _hue(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """HSV hue rotation by `shift` turns (`device_cache.py:61-102`)."""
    r, g, b = x[..., 0] / 255.0, x[..., 1] / 255.0, x[..., 2] / 255.0
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    sd = torch.where(d > 0.0, d, 1.0)
    # The sector by direct channel comparisons, as the JAX package picks it:
    # `mx == r` could match no branch if mx were computed apart from r. At a
    # tie either sector formula gives the same hue.
    is_r = (r >= g) & (r >= b)
    is_g = ~is_r & (g >= b)
    h = torch.where(is_r, torch.remainder((g - b) / sd, 6.0),
                    torch.where(is_g, (b - r) / sd + 2.0, (r - g) / sd + 4.0)) / 6.0
    h = torch.where(d > 0.0, h, 0.0)
    s = torch.where(mx > 0.0, d / torch.where(mx > 0.0, mx, 1.0), 0.0)
    v = mx
    h = h + shift[..., 0]
    h = h - torch.floor(h)
    hh = h * 6.0
    sector = torch.remainder(torch.floor(hh).to(torch.int32), 6)
    frac = hh - torch.floor(hh)
    p = v * (1.0 - s)
    q = v * (1.0 - s * frac)
    t = v * (1.0 - s * (1.0 - frac))
    nr = _select(sector, (v, q, p, p, t), v)
    ng = _select(sector, (t, v, v, q, p), p)
    nb = _select(sector, (p, p, t, v, v), q)
    return torch.clamp(torch.stack([nr, ng, nb], dim=-1) * 255.0, 0.0, 255.0)


def assemble_batch(data: torch.Tensor, idx: torch.Tensor, flip: torch.Tensor,
                   factors: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """[N, s, s, 3] uint8 cache and per-sample parameters (idx [B], flip
    [B], factors [B, 4] f32, order [B, 4]) → the [B, s, s, 3] uint8 batch,
    on the device of `data` (`device_cache.py:105-130`).

    The gather and the flip, then the four jitter ops in each sample's
    drawn order: at position k every op is evaluated and the one named by
    `order[:, k]` is selected per sample where its factor's sentinel
    enables it, so a disabled op keeps the values bit for bit (no identity
    arithmetic). All in f32; the final rounding is floor(x + 0.5), round
    half up as the C loader's lround, not torch.round's half to even."""
    x = data.index_select(0, idx.long()).float()
    x = torch.where(flip[:, None, None, None] > 0, x.flip(2), x)
    fb, fc, fs, fh = (factors[:, j][:, None, None, None] for j in range(4))
    gates = (factors[:, 0] >= 0.0, factors[:, 1] >= 0.0,
             factors[:, 2] >= 0.0, factors[:, 3] > -1.0)
    for k in range(4):
        op = order[:, k]
        outs = (_brightness(x, fb), _contrast(x, fc), _saturation(x, fs), _hue(x, fh))
        for j in range(4):
            sel = (op == j) & gates[j]
            x = torch.where(sel[:, None, None, None], outs[j], x)
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


class DeviceDataCache:
    """A dataset's resized images of one scale on `device`, and the batches
    assembled there (the module docstring)."""

    def __init__(self, dataset, device, *, augment: Optional[bool] = None,
                 jitter: Tuple[float, float, float, float] = DEFAULT_JITTER):
        self.device = torch.device(device)
        self.augment = bool(dataset.augment if augment is None else augment)
        self.jitter = tuple(jitter)
        self.n_images = len(dataset.paths)
        host = np.stack([dataset.resized_array(i) for i in range(self.n_images)])
        self.nbytes = host.nbytes
        self.data = torch.from_numpy(host).to(self.device)

    def assemble(self, idxs: Sequence[int], seeds: Sequence[int]) -> torch.Tensor:
        """The uint8 [B, s, s, 3] batch on the device for the pipeline's
        dataset indices (taken modulo the image count, as `dataset.get`
        takes them) and per-sample seeds: the drop-in for the decode in
        `DataPipeline._producer`. Only the indices and the parameters cross
        to the card, from pinned memory, asynchronously, on the calling
        thread's current stream; the batch is assembled on that stream."""
        idxs = np.asarray(idxs, np.int64) % self.n_images
        n = len(idxs)
        flips = np.empty(n, np.int32)
        factors = np.empty((n, 4), np.float32)
        orders = np.empty((n, 4), np.int32)
        for i, s in enumerate(seeds):
            flips[i], factors[i], orders[i] = draw_augment_params(
                np.random.RandomState(int(s)), self.jitter, self.augment)
        params = [torch.from_numpy(a) for a in (idxs, flips, factors, orders)]
        if self.device.type == "cuda":
            params = [p.pin_memory().to(self.device, non_blocking=True) for p in params]
        else:
            params = [p.to(self.device) for p in params]
        return assemble_batch(self.data, *params)


def resolve_device_data_cache(cfg, dataset, num_replicas: int = 1) -> bool:
    """Whether to use the cache, from `device_data_cache` ('auto' | True |
    False) (`device_cache.py:174-199`). 'auto' turns it on when there is
    one replica, the dataset has `resized_array` (a folder of images, not
    the synthetic set) and the resized images fit `device_cache_mb`. An
    explicit True raises when any of those is unmet instead of falling back
    to the host pipeline."""
    mode = cfg["device_data_cache"] if "device_data_cache" in cfg else False
    if mode is False or mode is None or mode == "false":
        return False
    has_arrays = hasattr(dataset, "resized_array")
    nbytes = len(dataset) * dataset.resolution ** 2 * 3 if has_arrays else 0
    budget = int(cfg["device_cache_mb"] if "device_cache_mb" in cfg else 256) << 20
    ok = int(num_replicas) == 1 and has_arrays and nbytes <= budget
    if mode == "auto":
        return ok
    if not ok:
        raise ValueError(
            "device_data_cache=true requires a single-process mesh (one replica), an "
            "ImageFolderDataset, and the resized dataset within device_cache_mb "
            f"({nbytes >> 20} MB vs {budget >> 20} MB)")
    return True
