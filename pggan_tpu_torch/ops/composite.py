"""Composite resampling ops — the counterpart of `pggan_tpu/ops/composite.py`:
`filtered_lrelu`, `conv2d_resample` and `grid_sample`.

4-D activations are logical NCHW tensors in `torch.channels_last` memory;
convolution weights are HWIO, as in the JAX package. `filtered_lrelu`'s
activation is `bias_act`'s leaky ReLU, so on a CUDA tensor without a clamp it
is one launch of the `bias_lrelu_gain` kernel; the rest is upfirdn2d, cuDNN and
torch ops. Everything is differentiable to any order.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops.basic import bias_act
from pggan_tpu_torch.ops.kernels import SQRT2
from pggan_tpu_torch.ops.resample import downsample2d, upfirdn2d, upsample2d


def filtered_lrelu(x: torch.Tensor, fu: Optional[torch.Tensor] = None,
                   fd: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
                   up: int = 1, down: int = 1, padding=0, gain: float = SQRT2,
                   slope: float = 0.2, clamp: Optional[float] = None) -> torch.Tensor:
    """bias → up-filter → leaky ReLU (gain, clamp) → down-filter
    (`composite.py:36-62`). The bias is added before the up stage; `padding`
    is applied around the up stage as given (no centring), and the up stage
    carries the up² gain."""
    if b is not None:
        x = x + b.view(1, -1, 1, 1).to(x.dtype)
    px = padding if isinstance(padding, int) else max(abs(p) for p in padding)
    if up > 1 or fu is not None or px:
        x = upfirdn2d(x, fu, up=up, padding=padding, gain=float(up * up))
    x = bias_act(x, None, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    if down > 1 or fd is not None:
        x = upfirdn2d(x, fd, down=down)
    return x


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Optional[torch.Tensor] = None,
                    up: int = 1, down: int = 1, padding: int = 0, groups: int = 1,
                    flip_weight: bool = True) -> torch.Tensor:
    """Convolution with integrated up/down sampling (`composite.py:65-96`):
    up > 1 upsamples with `f` first; down > 1 downsamples with `f` after, or
    is the convolution's stride when there is no filter. w is HWIO;
    `flip_weight=True` is correlation (`F.conv2d`)."""
    if not flip_weight:
        w = w.flip([0, 1])
    if up > 1:
        x = upsample2d(x, f, up=up, padding=padding)
        padding = 0
    stride = down if (down > 1 and f is None) else 1
    y = F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride, padding=padding,
                 groups=groups)
    if down > 1 and f is not None:
        y = downsample2d(y, f, down=down)
    return y


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of [B, C, H, W] at grid [B, Ho, Wo, 2] ((x, y) in
    [-1, 1]) with zero padding and align_corners=False
    (`composite.py:99-116`).

    The four corners are gathered and weighted in torch ops, in the order
    of the JAX package's `map_coordinates(order=1, mode='constant')`, so
    autograd differentiates it to any order on every device. `F.grid_sample`
    computes the same forward, but on CUDA its backward has no derivative
    (`grid_sampler_2d_backward`), which R1-style double backward needs."""
    n, _, h, w = x.shape
    rows = x.permute(0, 2, 3, 1)                         # [B, H, W, C]
    gx = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    batch = torch.arange(n, device=x.device).view(n, 1, 1)
    corners = []
    for c in (gy, gx):
        lower = c.floor()
        upper_weight = c - lower
        i = lower.long()
        corners.append(((i, 1.0 - upper_weight), (i + 1, upper_weight)))
    out = None
    for (iy, wy), (ix, wx) in itertools.product(*corners):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        value = rows[batch, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        term = (wy * wx)[..., None] * torch.where(valid[..., None], value, 0.0)
        out = term if out is None else out + term
    return out.permute(0, 3, 1, 2)
