"""Elementwise, normalisation and resize primitives of the generator and
the discriminator — the counterpart of `pggan_tpu/ops/basic.py`.

4-D activations are logical NCHW tensors in `torch.channels_last` memory
(NHWC bytes); the channel axis is dim 1. `pixel_norm`, `lrelu_pixel_norm`
and the statistic of `minibatch_stddev` go to the kernel wrappers in
`ops/kernels.py`, which run the CUDA kernel on a CUDA tensor and the plain
version on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops import kernels


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def blend(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """(1 - alpha)·a + alpha·b — the progressive fade-in blend.

    Both weights are f32 (as `pggan_tpu/ops/basic.py:48-64`: a bf16 alpha
    would quantise the fade to 2⁻⁸ steps) and so is the arithmetic; the
    result returns in a's dtype.
    """
    w_b = np.float32(alpha)
    w_a = np.float32(1.0) - w_b
    out = float(w_a) * a.float() + float(w_b) * b.float()
    return out.to(a.dtype)


def pixel_norm(x: torch.Tensor, eps: float = kernels.EPS) -> torch.Tensor:
    """x · rsqrt(mean_C(x²) + eps) over the channel axis (dim 1)."""
    return kernels.pixel_norm(x, eps)


def lrelu_pixel_norm(x: torch.Tensor, slope: float = 0.2,
                     eps: float = kernels.EPS) -> torch.Tensor:
    """pixel_norm(leaky_relu(x)) — the generator's conv epilogue."""
    return kernels.lrelu_pixel_norm(x, slope, eps)


def upscale2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upscale of [B, C, H, W] by an integer factor."""
    if not isinstance(factor, int) or factor < 1:
        raise ValueError(f"factor must be a positive int, got {factor!r}")
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def downscale2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Average-pool downscale of [B, C, H, W] by an integer factor
    (`pggan_tpu/ops/basic.py:108-125`). Integer images are pooled in f32.
    The JAX package sums the window in the input dtype; `avg_pool2d`
    accumulates bf16 in f32 on the card, so bf16 results may differ from it
    by a bf16 rounding."""
    if not isinstance(factor, int) or factor < 1:
        raise ValueError(f"factor must be a positive int, got {factor!r}")
    if factor == 1:
        return x
    if not x.is_floating_point():
        x = x.float()
    return F.avg_pool2d(x, factor)


def minibatch_stddev(x: torch.Tensor, subgroup_size: int = 4,
                     eps: float = kernels.EPS) -> torch.Tensor:
    """Append the minibatch-stddev channel to [N, C, H, W]
    (`pggan_tpu/ops/basic.py:128-161`): per subgroup of sg = min(N, 4)
    samples (sg = N when N is not a multiple of it), the unbiased variance
    over the subgroup, sqrt(var + eps), averaged over C, H, W; repeated for
    the sg samples as one more channel. N == 1 appends a zero channel."""
    n, _, h, w = x.shape
    sg = kernels.subgroup_size(n, subgroup_size)
    if sg <= 1:
        stat = torch.zeros((n,), dtype=torch.float32, device=x.device)
    else:
        stat = kernels.minibatch_stddev_stat(x, sg, eps).repeat_interleave(sg)
    channel = stat.to(x.dtype).view(n, 1, 1, 1).expand(n, 1, h, w)
    return torch.cat([x, channel], dim=1).contiguous(memory_format=torch.channels_last)
