"""LPIPS-style perceptual distance — the counterpart of
`pggan_tpu/losses/perceptual.py` (the reference's `submodel/lpips.py:6-70`).

torchvision AlexNet's `features` (convs 11/5/3/3/3 with paddings 2/2/1/1/1,
strides 4/1/1/1/1, biases, unpadded 3×3/2 max-pools after relu1 and relu2),
tapped after each ReLU; each tap unit-normalised over channels with
rsqrt(Σc² + 1e-10), the squared difference weighted by a learned 1×1 conv,
averaged over space, summed over the five layers, averaged over the batch.

`PerceptualDistance` is an `nn.Module` whose keys are the reference
`LPIPS` module's (`alexnet.layers.{0,3,6,8,10}`, `lpips_weights.{i}.main.1`),
so `convert_lpips_state_dict` loads a reference state_dict strictly.
`params_from_jax` takes the JAX package's npz key convention (`conv{i}_w`
HWIO, `conv{i}_b`, `lin{i}`): the arrays of `convert_lpips_state_dict` there,
or of its `load_backbone_weights` / `load_linear_weights` files. These two
are the only ways weights come in; without them the convs are He-normal from a `torch.Generator` seeded by `seed`
(a relative distance only) and the 1×1 weights 1/C.
"""

from __future__ import annotations

import math
from typing import List, Mapping

import numpy as np
import torch
from torch import nn

from pggan_tpu_torch.models.backbones import JaxArrays, as_tensors

WIDTHS = (64, 192, 384, 256, 256)
_KERNELS = (11, 5, 3, 3, 3)
_STRIDES = (4, 1, 1, 1, 1)
_PADS = (2, 2, 1, 1, 1)
# Indices of the convs in torchvision's `alexnet().features`, and of the
# ReLUs whose outputs are the taps.
CONV_INDEX = (0, 3, 6, 8, 10)
_TAPS = (1, 4, 7, 9, 11)


class _LinLayer(nn.Module):
    """The reference's NetLinLayer: (Dropout,) bias-free 1×1 conv to one
    channel; the dropout is the identity at inference."""

    def __init__(self, channels: int):
        super().__init__()
        self.main = nn.Sequential(nn.Identity(),
                                  nn.utils.skip_init(nn.Conv2d, channels, 1, 1, bias=False))


class _AlexNet(nn.Module):
    def __init__(self, gen: torch.Generator):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for i, (cout, k, s, p) in enumerate(zip(WIDTHS, _KERNELS, _STRIDES, _PADS)):
            conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, s, p)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                                  * math.sqrt(2.0 / (k * k * cin)))
                conv.bias.zero_()
            layers += [conv, nn.ReLU()]
            if i < 2:
                layers.append(nn.MaxPool2d(3, 2))
            cin = cout
        self.layers = nn.Sequential(*layers)


class PerceptualDistance(nn.Module):
    """Mean perceptual distance between two [B, 3, H, W] batches in [-1, 1],
    computed in the weights' dtype (f32, as the JAX package casts; under
    autocast the convs follow it)."""

    def __init__(self, seed: int = 7, device="cuda"):
        super().__init__()
        self.alexnet = _AlexNet(torch.Generator().manual_seed(int(seed)))
        self.lpips_weights = nn.ModuleList(_LinLayer(c) for c in WIDTHS)
        with torch.no_grad():
            for c, lin in zip(WIDTHS, self.lpips_weights):
                lin.main[1].weight.fill_(1.0 / c)
        self.to(device)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, y = [], x.to(self.alexnet.layers[0].weight.dtype)
        for i, layer in enumerate(self.alexnet.layers):
            y = layer(y)
            if i in _TAPS:
                feats.append(y)
        return feats

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for fa, fb, lin in zip(self.features(a), self.features(b), self.lpips_weights):
            na = fa * torch.rsqrt(fa.square().sum(dim=1, keepdim=True) + 1e-10)
            nb = fb * torch.rsqrt(fb.square().sum(dim=1, keepdim=True) + 1e-10)
            d = lin.main((na - nb).square())                  # [B, 1, H, W]
            total = total + d.mean(dim=(1, 2, 3))
        return total.mean()


def convert_lpips_state_dict(sd: Mapping, device="cuda") -> PerceptualDistance:
    """A reference `LPIPS().state_dict()` (`submodel/lpips.py:6-23`) loaded
    strictly into a `PerceptualDistance` on `device`."""
    module = PerceptualDistance(device="cpu")
    module.load_state_dict(as_tensors(sd), strict=True)
    return module.to(device)


def params_from_jax(arrays: Mapping[str, np.ndarray], device="cuda") -> PerceptualDistance:
    """A `PerceptualDistance` with the JAX package's arrays (`conv{i}_w`
    [k, k, in, out], `conv{i}_b`, `lin{i}` [C]), on `device`."""
    jx = JaxArrays({k.replace("_", "/"): v for k, v in arrays.items()})
    for i, idx in enumerate(CONV_INDEX):
        jx.conv(f"alexnet.layers.{idx}", f"conv{i}", bias=True)
        jx.put(f"lpips_weights.{i}.main.1.weight", jx.take(f"lin{i}").reshape(1, -1, 1, 1))
    return jx.load(PerceptualDistance(device="cpu")).to(device)
