"""Progressive generator as an `nn.Module` — the counterpart of
`pggan_tpu/models/generator.py:57-263`.

  latent [B, latent_dim]
    → pixel_norm
    → EqualizedLinear(latent_dim → 16·depths[0]) + leaky ReLU
    → view [B, depths[0], 4, 4] (NCHW-major, as the reference's torch
      reshape) → channels_last → pixel_norm
    → first block: EqConv3x3 + lrelu_pixel_norm
    → per grown block i (1..scale): nearest upscale ×2 fused into conv0,
      then [EqConv3x3 + lrelu_pixel_norm] × 2 (conv0's epilogue included)
    → toRGB 1×1 conv of the last block, and at scale ≥ 1 the RGB-domain
      fade (1-α)·upscale(toRGB[-2](penultimate)) + α·toRGB[-1](x)
    → optional last activation; output [B, H, W, output_dim] (NHWC, the
      JAX package's layout).

Activations inside are channels_last, so each epilogue hands the kernels
NHWC rows; under autograd the epilogues' backward is the backward kernel.
Growth appends a block and its toRGB; weights are drawn from a
`torch.Generator` seeded per component, so growing a generator of scale s
gives the same weights as building one of scale s+1. The JAX package's
packed high-resolution path (`hires_pack`) is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pggan_tpu_torch.ops.basic import (blend, leaky_relu, lrelu_pixel_norm,
                                       pixel_norm, upscale2d)
from pggan_tpu_torch.ops.equalized import (NET_G, EqualizedConv2d,
                                           EqualizedLinear, component_rng,
                                           load_params_from_jax, params_to_jax)
from pggan_tpu_torch.ops.fused_scale import upscale_conv3x3_dilated

__all__ = ["Generator", "GeneratorBlock", "fuses_upscale", "load_params_from_jax",
           "params_from_jax", "params_to_jax"]

# Component ids of the per-component seeds (the same ids as the JAX package).
_KEY_FORMAT, _KEY_FIRST, _KEY_BLOCK, _KEY_TORGB = 0, 1, 100, 200


def _component_rng(seed: int, *component: int) -> torch.Generator:
    return component_rng(seed, NET_G, *component)


def fuses_upscale(fused_scale, cout: int) -> bool:
    """Whether a block of `cout` channels takes the fused upscale+conv form.

    Every `fused_scale` value of the JAX package maps onto one of two exact
    forms: 'dilated', True, 'auto' when cout < 128 and a number N when
    cout <= N take `upscale_conv3x3_dilated`; the rest take
    conv3x3(upscale2d(x)) (`generator.py:157-174`).
    """
    if fused_scale == "dilated" or fused_scale is True:
        return True
    if fused_scale is False or fused_scale is None:
        return False
    if fused_scale == "auto":
        return cout < 128
    return cout <= int(fused_scale)


class GeneratorBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, seed: int, index: int,
                 equalized: bool, init_bias_to_zero: bool):
        super().__init__()
        kw = dict(equalized=equalized, init_bias_to_zero=init_bias_to_zero)
        self.conv0 = EqualizedConv2d(
            in_ch, out_ch, 3, generator=_component_rng(seed, _KEY_BLOCK + index, 0), **kw)
        self.conv1 = EqualizedConv2d(
            out_ch, out_ch, 3, generator=_component_rng(seed, _KEY_BLOCK + index, 1), **kw)


class Generator(nn.Module):
    def __init__(self, *, latent_dim: int, depths: Sequence[int], scale: int = 0,
                 output_dim: int = 3, equalized_lr: bool = True,
                 init_bias_to_zero: bool = True, slope: float = 0.2,
                 apply_pixel_norm: bool = True,
                 last_activation: Optional[str] = None,
                 fused_scale="dilated", seed: int = 0):
        super().__init__()
        if last_activation not in (None, "", "none", "linear", "tanh", "sigmoid"):
            raise ValueError(f"unsupported last activation {last_activation!r}")
        self.depths = [int(d) for d in depths]
        self.output_dim = int(output_dim)
        self.slope = float(slope)
        self.apply_pixel_norm = bool(apply_pixel_norm)
        self.last_activation = last_activation
        self.fused_scale = fused_scale
        self.seed = int(seed)
        self._kw = dict(equalized=bool(equalized_lr),
                        init_bias_to_zero=bool(init_bias_to_zero))
        d0 = self.depths[0]
        self.format = EqualizedLinear(
            latent_dim, 16 * d0, generator=_component_rng(seed, _KEY_FORMAT), **self._kw)
        self.first_conv = EqualizedConv2d(
            d0, d0, 3, generator=_component_rng(seed, _KEY_FIRST), **self._kw)
        self.blocks = nn.ModuleList()
        self.torgb = nn.ModuleList([EqualizedConv2d(
            d0, output_dim, 1, generator=_component_rng(seed, _KEY_TORGB), **self._kw)])
        for _ in range(scale):
            self.grow()

    @property
    def scale(self) -> int:
        return len(self.blocks)

    @property
    def resolution(self) -> int:
        return 4 * 2 ** self.scale

    def grow(self) -> None:
        """Append one scale: a [conv0, conv1] block and its toRGB head
        (`generator.py:84-108`), on the device of the existing weights."""
        index = self.scale + 1
        if index >= len(self.depths):
            raise ValueError(f"depths {self.depths} allow at most "
                             f"{len(self.depths) - 1} blocks")
        device = self.format.weight.device
        self.blocks.append(GeneratorBlock(
            self.depths[index - 1], self.depths[index], seed=self.seed,
            index=index, **self._kw).to(device))
        self.torgb.append(EqualizedConv2d(
            self.depths[index], self.output_dim, 1,
            generator=_component_rng(self.seed, _KEY_TORGB + index), **self._kw
        ).to(device))

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        """Conv epilogue: leaky ReLU then pixel norm, one kernel on the card."""
        if self.apply_pixel_norm:
            return lrelu_pixel_norm(x, self.slope)
        return leaky_relu(x, self.slope)

    def _block(self, block: GeneratorBlock, x: torch.Tensor,
               dt: torch.dtype) -> torch.Tensor:
        conv0 = block.conv0
        if fuses_upscale(self.fused_scale, conv0.weight.shape[0]):
            x = upscale_conv3x3_dilated(x, conv0.weight, conv0.bias, conv0.scale,
                                        compute_dtype=dt)
        else:
            x = conv0(upscale2d(x), compute_dtype=dt)
        x = self._act(x)
        return self._act(block.conv1(x, compute_dtype=dt))

    def forward(self, latent: torch.Tensor, alpha: float, *,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, latent_dim] → images [B, H, W, output_dim], NHWC."""
        dt = compute_dtype
        x = latent.to(dt)
        if self.apply_pixel_norm:
            x = pixel_norm(x)
        x = leaky_relu(self.format(x, compute_dtype=dt), self.slope)
        x = x.view(x.shape[0], self.depths[0], 4, 4)
        x = x.contiguous(memory_format=torch.channels_last)
        if self.apply_pixel_norm:
            x = pixel_norm(x)
        x = self._act(self.first_conv(x, compute_dtype=dt))

        penultimate = x
        for block in self.blocks:
            penultimate = x
            x = self._block(block, x, dt)

        out = self.torgb[-1](x, compute_dtype=dt)
        if self.scale >= 1:
            prev = upscale2d(self.torgb[-2](penultimate, compute_dtype=dt))
            out = blend(prev, out, alpha)
        if self.last_activation == "tanh":
            out = torch.tanh(out)
        elif self.last_activation == "sigmoid":
            out = torch.sigmoid(out)
        return out.permute(0, 2, 3, 1)


def params_from_jax(arrays: Dict[str, np.ndarray], **options) -> Generator:
    """Build a Generator whose structure and weights are those of the JAX
    package's arrays. `options` are the Generator's forward settings
    (slope, apply_pixel_norm, last_activation, fused_scale)."""
    scale = len({k.split("/")[1] for k in arrays if k.startswith("blocks/")})
    depths = [int(arrays["first_conv/w"].shape[3])]
    depths += [int(arrays[f"blocks/{i}/conv0/w"].shape[3]) for i in range(scale)]
    module = Generator(
        latent_dim=int(arrays["format/w"].shape[0]), depths=depths, scale=scale,
        output_dim=int(arrays["torgb/0/w"].shape[3]), **options)
    return load_params_from_jax(module, arrays)
