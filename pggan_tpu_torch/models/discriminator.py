"""Progressive discriminator as an `nn.Module` — the counterpart of
`pggan_tpu/models/discriminator.py:41-200`.

  images [B, R, R, input_dim] (NHWC, as the JAX package takes them; viewed
    as channels_last NCHW without a copy), R = 4 · 2^scale
    → fromRGB 1×1 conv + leaky ReLU at the active scale
    → per grown block, walked outermost-first: 2 × [EqConv3x3 + leaky ReLU]
      then a 2× average pool; after the first block, the feature-domain fade
      (1-α)·lrelu(fromRGB[-2](downscale2d(images))) + α·x
    → minibatch-stddev channel (the CUDA statistic kernel on the card)
    → last EqConv3x3 on d0+1 channels + leaky ReLU → NCHW-major flatten
      → EqLinear(16·d0 → d0) + leaky ReLU → decision EqLinear(d0 → size)

Block i (1-based) maps depths[i] → depths[i-1] channels and halves the
resolution; fromRGB i maps input_dim → depths[i]. Growth appends a block and
its fromRGB, with weights drawn per component as in the generator but under
D's network id, so growing a discriminator of scale s gives the same weights
as building one of scale s+1. The packed high-resolution path (`hires_pack`)
and per-block rematerialisation (`remat`) are not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from pggan_tpu_torch.ops.basic import blend, downscale2d, leaky_relu, minibatch_stddev
from pggan_tpu_torch.ops.equalized import (NET_D, EqualizedConv2d,
                                           EqualizedLinear, component_rng,
                                           load_params_from_jax)

# Component ids of the per-component seeds (`discriminator.py:34-38`).
_KEY_FROMRGB, _KEY_BLOCK = 300, 400
_KEY_LAST_CONV, _KEY_LAST_LINEAR, _KEY_DECISION = 5, 6, 7


class DiscriminatorBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, seed: int, index: int,
                 equalized: bool, init_bias_to_zero: bool):
        super().__init__()
        kw = dict(equalized=equalized, init_bias_to_zero=init_bias_to_zero)
        self.conv0 = EqualizedConv2d(in_ch, in_ch, 3, generator=component_rng(
            seed, NET_D, _KEY_BLOCK + index, 0), **kw)
        self.conv1 = EqualizedConv2d(in_ch, out_ch, 3, generator=component_rng(
            seed, NET_D, _KEY_BLOCK + index, 1), **kw)


class Discriminator(nn.Module):
    def __init__(self, *, depths: Sequence[int], scale: int = 0, input_dim: int = 3,
                 decision_layer_size: int = 1, apply_minibatch_norm: bool = True,
                 equalized_lr: bool = True, init_bias_to_zero: bool = True,
                 slope: float = 0.2, seed: int = 0):
        super().__init__()
        self.depths = [int(d) for d in depths]
        self.input_dim = int(input_dim)
        self.apply_minibatch_norm = bool(apply_minibatch_norm)
        self.slope = float(slope)
        self.seed = int(seed)
        self._kw = dict(equalized=bool(equalized_lr),
                        init_bias_to_zero=bool(init_bias_to_zero))
        d0 = self.depths[0]
        self.fromrgb = nn.ModuleList([self._fromrgb(0, d0)])
        self.blocks = nn.ModuleList()
        self.last_conv = EqualizedConv2d(
            d0 + 1 if self.apply_minibatch_norm else d0, d0, 3,
            generator=component_rng(seed, NET_D, _KEY_LAST_CONV), **self._kw)
        self.last_linear = EqualizedLinear(
            16 * d0, d0, generator=component_rng(seed, NET_D, _KEY_LAST_LINEAR),
            **self._kw)
        self.decision = EqualizedLinear(
            d0, int(decision_layer_size),
            generator=component_rng(seed, NET_D, _KEY_DECISION), **self._kw)
        for _ in range(scale):
            self.grow()

    def _fromrgb(self, index: int, depth: int) -> EqualizedConv2d:
        return EqualizedConv2d(self.input_dim, depth, 1, generator=component_rng(
            self.seed, NET_D, _KEY_FROMRGB + index), **self._kw)

    @property
    def scale(self) -> int:
        return len(self.blocks)

    def grow(self) -> None:
        """Append one scale: a [conv0, conv1] block and its fromRGB
        (`discriminator.py:73-95`), on the device of the existing weights."""
        index = self.scale + 1
        if index >= len(self.depths):
            raise ValueError(f"depths {self.depths} allow at most "
                             f"{len(self.depths) - 1} blocks")
        device = self.decision.weight.device
        self.blocks.append(DiscriminatorBlock(
            self.depths[index], self.depths[index - 1], seed=self.seed,
            index=index, **self._kw).to(device))
        self.fromrgb.append(self._fromrgb(index, self.depths[index]).to(device))

    def _lrelu(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.slope)

    def forward(self, images: torch.Tensor, alpha: float, *,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, H, W, input_dim] (NHWC) → logits [B, decision_layer_size]."""
        dt = compute_dtype
        x = images.permute(0, 3, 1, 2).to(dt)
        if self.scale >= 1:
            x_down = self._lrelu(self.fromrgb[-2](downscale2d(x), compute_dtype=dt))
        y = self._lrelu(self.fromrgb[-1](x, compute_dtype=dt))
        for pos, block in enumerate(reversed(self.blocks)):
            y = self._lrelu(block.conv0(y, compute_dtype=dt))
            y = downscale2d(self._lrelu(block.conv1(y, compute_dtype=dt)))
            if pos == 0:
                y = blend(x_down, y, alpha)
        if self.apply_minibatch_norm:
            y = minibatch_stddev(y)
        y = self._lrelu(self.last_conv(y, compute_dtype=dt))
        # NCHW-major flatten, as the reference's torch view
        # (`discriminator.py:192-194`).
        y = y.reshape(y.shape[0], -1)
        y = self._lrelu(self.last_linear(y, compute_dtype=dt))
        return self.decision(y, compute_dtype=dt)


def params_from_jax(arrays: Dict[str, np.ndarray], **options) -> Discriminator:
    """Build a Discriminator whose structure and weights are those of the JAX
    package's arrays. `options` are its forward settings (slope)."""
    scale = len({k.split("/")[1] for k in arrays if k.startswith("blocks/")})
    d0 = int(arrays["last_conv/w"].shape[3])
    depths = [d0] + [int(arrays[f"blocks/{i}/conv0/w"].shape[3]) for i in range(scale)]
    module = Discriminator(
        depths=depths, scale=scale, input_dim=int(arrays["fromrgb/0/w"].shape[2]),
        decision_layer_size=int(arrays["decision/w"].shape[1]),
        apply_minibatch_norm=int(arrays["last_conv/w"].shape[2]) == d0 + 1, **options)
    return load_params_from_jax(module, arrays)
