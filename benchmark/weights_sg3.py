"""The weights of a StyleGAN3 cell, made on its device from the seed: one
normal draw cut into the reference's parameters and buffers
(`reference/stylegan3.py:param_shapes`, NVIDIA's names), each given
NVIDIA's initialisation: weights N(0, 1) (the mapping's divided by its lr
multiplier, which its run-time gain multiplies back), affine biases 1,
other biases and `w_avg` 0, the input layer's `transform` the identity, its
affine bias (1, 0, 0, 0), its frequencies drawn in a disc of radius
`first_cutoff` and its phases uniform in [−0.5, 0.5) as NVIDIA draws them
(the uniform draw is the normal one through its CDF). Two exceptions, the
configuration's `assumed`: the input layer's affine weight is N(0, 0.1²)
where NVIDIA starts it at 0, so that the per-sample rotation and
translation carry weight; and each layer's `magnitude_ema`, which a trained
network holds as the moving mean square of the layer's input, is set by one
calibration pass of the reference on a seeded latent
(`reference.stylegan3.calibrate_magnitudes`), where NVIDIA starts it at 1,
so that every layer's input arrives at unit RMS (with 1, the low-pass
filters thin the signal layer by layer, and the untrained network's images
fade to grey). The program and the reference get the same values; neither
makes them."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import stylegan3 as ref

INPUT_AFFINE_STD = 0.1


def _init(name: str, draw: torch.Tensor, model: dict) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("mapping.") and leaf == "weight":
        return draw / float(model["mapping_lr_multiplier"])
    if name == "synthesis.input.affine.weight":
        return draw * INPUT_AFFINE_STD
    if name == "synthesis.input.affine.bias":
        return torch.tensor([1.0, 0.0, 0.0, 0.0], device=draw.device)
    if leaf == "transform":
        return torch.eye(3, device=draw.device)
    if leaf == "freqs":
        radii = draw.square().sum(dim=1, keepdim=True).sqrt()
        return draw / (radii * radii.square().exp().pow(0.25)) * float(model["first_cutoff"])
    if leaf == "phases":
        return 0.5 * torch.erf(draw / math.sqrt(2.0))            # the normal's CDF − 0.5
    if leaf == "magnitude_ema":
        return torch.ones_like(draw)       # until the calibration pass
    if leaf == "weight":
        return draw
    if name.endswith("affine.bias"):
        return torch.ones_like(draw)
    return torch.zeros_like(draw)          # the other biases, w_avg


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on `device`} for every parameter and buffer."""
    shapes = ref.param_shapes(model)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(s) for _, s in shapes), generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = _init(name, flat[offset:offset + n].view(shape), model)
        offset += n
    z = torch.randn((1, int(model["z_dim"])), generator=gen, device=device)
    with torch.no_grad():
        ref.calibrate_magnitudes(out, z, model)
    return out
