"""The weights of a cell, made on its device from the seed: one normal draw
for each network (the published initialisation: N(0, 1) weights under the
equalized learning rate, zero biases), cut into the reference's layers.
The program and the reference get the same values; neither makes them."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import model as ref


def networks(model: dict) -> Dict[str, list]:
    depths, scale = model["depths"], int(model["scale"])
    return {"G": ref.g_layers(depths, scale, int(model["latent_dim"])),
            "D": ref.d_layers(depths, scale)}


def make_weights(model: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'G': {name: tensor}, 'D': {...}}: `<layer>.weight` and `<layer>.bias`
    in f32 on `device`."""
    if not model.get("init_bias_to_zero", True):
        raise ValueError("the benchmark draws zero biases; the model asks for others")
    out = {}
    for index, (net, layers) in enumerate(networks(model).items()):
        gen = torch.Generator(device=device).manual_seed(int(seed) * 2 + index)
        flat = torch.randn(sum(math.prod(s) for _, s in layers), generator=gen, device=device)
        params, offset = {}, 0
        for name, shape in layers:
            n = math.prod(shape)
            params[name + ".weight"] = flat[offset:offset + n].view(shape)
            params[name + ".bias"] = torch.zeros(shape[0], device=device)
            offset += n
        out[net] = params
    return out


@torch.no_grad()
def load_into(net: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy `params` into the module's parameters of the same names; the
    name sets must be equal."""
    own = dict(net.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"weights and module differ: only in the module "
                       f"{sorted(set(own) - set(params))[:5]}, only in the weights "
                       f"{sorted(set(params) - set(own))[:5]}")
    for name, p in own.items():
        p.copy_(params[name])
