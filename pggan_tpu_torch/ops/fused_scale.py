"""Nearest-neighbour upsample fused with the 3×3 conv of a generator block
head — the counterpart of `pggan_tpu/ops/fused_scale.py:45,69-96`.

`conv3x3(upscale2d(x))` duplicates pixels before convolving, so taps that
read one source pixel can be summed in the kernel first. Along each axis the
3 taps (w0, w1, w2) merge into the 4 taps (w0, w0+w1, w1+w2, w2) of a kernel
K4 = M4·w·M4ᵀ that slides over the zero-dilated low-resolution input
(`_M4` at `fused_scale.py:45`). An lhs-dilated convolution is a transposed
convolution with the kernel flipped and in/out swapped, so

    conv3x3(upscale2d(x), w) + b == conv_transpose2d(x, flip(K4)ᵀ, b,
                                                     stride=2, padding=1)

exactly, up to summation order. Each output pixel then costs 2×2 taps
instead of 3×3, and the 4× upscaled intermediate is never written.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops.equalized import scaled_weight_bias


def _merge_taps(w: torch.Tensor, dim: int) -> torch.Tensor:
    """Along `dim`: (w0, w1, w2) → (w0, w0+w1, w1+w2, w2), i.e. M4 · w."""
    w0, w1, w2 = w.unbind(dim)
    return torch.stack([w0, w0 + w1, w1 + w2, w2], dim)


def upscale_conv3x3_dilated(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, scale: torch.Tensor, *,
                            compute_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Exactly `equalized_conv2d(upscale2d(x), weight, bias, scale)` for an
    OIHW 3×3 weight, as one stride-2 transposed convolution of x."""
    dt = compute_dtype or x.dtype
    w, b = scaled_weight_bias(weight, bias, scale, torch.float32)
    k4 = _merge_taps(_merge_taps(w, 2), 3)             # [O, I, 4, 4]
    k4t = k4.flip(2, 3).transpose(0, 1).to(dt)         # [I, O, 4, 4]
    return F.conv_transpose2d(x.to(dt), k4t, b.to(dt), stride=2, padding=1)
