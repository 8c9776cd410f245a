"""Elementwise, normalisation and resize primitives of the generator and
the discriminator — the counterpart of `pggan_tpu/ops/basic.py`.

4-D activations are logical NCHW tensors in `torch.channels_last` memory
(NHWC bytes); the channel axis is dim 1. `pixel_norm`, `lrelu_pixel_norm`,
the statistic of `minibatch_stddev` and `bias_act`'s leaky-ReLU case go to
the kernel wrappers in `ops/kernels.py`, which run the CUDA kernel on a CUDA
tensor and the plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops import kernels


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def blend(a: torch.Tensor, b: torch.Tensor, alpha) -> torch.Tensor:
    """(1 - alpha)·a + alpha·b — the progressive fade-in blend.

    Both weights are f32 (as `pggan_tpu/ops/basic.py:48-64`: a bf16 alpha
    would quantise the fade to 2⁻⁸ steps) and so is the arithmetic; the
    result returns in a's dtype. `alpha` is a float or a 0-d tensor on a's
    device, read when the blend runs (a captured step reads it at every
    replay, as JAX's traced alpha); both round alike: w_b = f32(alpha),
    w_a = 1 − w_b in f32.
    """
    if isinstance(alpha, torch.Tensor):
        w_b = alpha.to(dtype=torch.float32)
        w_a = 1.0 - w_b
    else:
        w_b = np.float32(alpha)
        w_a = float(np.float32(1.0) - w_b)
        w_b = float(w_b)
    out = w_a * a.float() + w_b * b.float()
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


# name: (fn(x, alpha), default alpha, default gain) — `basic.py:177-188`
_ACTIVATIONS = {
    "linear":   (lambda x, a: x,                               0.0, 1.0),
    "relu":     (lambda x, a: torch.clamp_min(x, 0.0),         0.0, kernels.SQRT2),
    "lrelu":    (lambda x, a: torch.where(x >= 0, x, x * a),   0.2, kernels.SQRT2),
    "tanh":     (lambda x, a: torch.tanh(x),                   0.0, 1.0),
    "sigmoid":  (lambda x, a: torch.sigmoid(x),                0.0, 1.0),
    "elu":      (lambda x, a: F.elu(x),                        0.0, 1.0),
    "selu":     (lambda x, a: F.selu(x),                       0.0, 1.0),
    "softplus": (lambda x, a: F.softplus(x),                   0.0, 1.0),
    "swish":    (lambda x, a: F.silu(x),                       0.0, kernels.SQRT2),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """Bias add along `dim`, activation, gain and symmetric clamp
    (`pggan_tpu/ops/basic.py:191-223`). `alpha` is the activation's shape
    parameter (the lrelu slope); the defaults are the activation's.

    Leaky ReLU without a clamp on a tensor of 2 or more dims is
    `kernels.bias_lrelu_gain` (the CUDA kernel on a CUDA tensor, which
    needs `dim` innermost in memory; f32 math). Everything else is torch
    ops in x's dtype, as the JAX package's xla path computes it."""
    if act not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if clamp is not None and clamp < 0:
        raise ValueError("clamp must be non-negative")
    fn, def_alpha, def_gain = _ACTIVATIONS[act]
    alpha = def_alpha if alpha is None else float(alpha)
    gain = def_gain if gain is None else float(gain)
    if act == "lrelu" and clamp is None and x.ndim >= 2:
        return kernels.bias_lrelu_gain(x, b, alpha, gain, dim)
    if b is not None:
        x = x + kernels.along(b, x.ndim, dim).to(x.dtype)
    x = fn(x, alpha)
    if gain != 1.0:
        x = x * torch.tensor(gain, dtype=x.dtype)     # the gain rounded to x's dtype
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a · b + c (`pggan_tpu/ops/basic.py:226-228`)."""
    return a * b + c
