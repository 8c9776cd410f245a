"""The weights of a StyleGAN2 cell, made on its device from the seed: one
normal draw cut into the reference's parameters and buffers
(`reference/stylegan2.py:param_shapes`, NVIDIA's names), each given
NVIDIA's initialisation: weights N(0, 1) (the mapping's divided by its lr
multiplier, which its run-time gain multiplies back), affine biases 1, other
biases and `w_avg` 0, the 4×4 constant and every `noise_const` N(0, 1), and
each noise strength N(0, 0.1²) where NVIDIA starts it at 0 (the
configuration's `assumed`). The program and the reference get the same
values; neither makes them."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import stylegan2 as ref

NOISE_STRENGTH_STD = 0.1


def _init(name: str, draw: torch.Tensor, model: dict) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("mapping.") and leaf == "weight":
        return draw / float(model["mapping_lr_multiplier"])
    if leaf == "noise_strength":
        return draw * NOISE_STRENGTH_STD
    if leaf in ("weight", "const", "noise_const"):
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
    return out


@torch.no_grad()
def load_into(net: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy `params` into the module's state of the same names; the name
    sets must be equal."""
    own = net.state_dict(keep_vars=True)
    if set(own) != set(params):
        raise KeyError(f"weights and module differ: only in the module "
                       f"{sorted(set(own) - set(params))[:5]}, only in the weights "
                       f"{sorted(set(params) - set(own))[:5]}")
    for name, t in own.items():
        t.copy_(params[name])
