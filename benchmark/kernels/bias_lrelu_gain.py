"""Bias + leaky ReLU·gain, clamped (`csrc/bias_act.cu`): StyleGAN2's
mapping FCs and conv epilogues, y = clamp(lrelu(x + b)·√2, ±256) in f32.

Its calls are a StyleGAN2 forward's 25: the 8 mapping layers ([B, w_dim])
and the 17 synthesis convs ([B, C, r, r]); a PGGAN model calls it nowhere.
`cost` takes the cell's itemsize for all of them, so the mapping's and the
float32 blocks' launches (up to 64²) are costed at half their bytes in a
bf16 cell, which understates their bound; they are 2 % of the bytes at
config-f."""

import math

from benchmark.reference import stylegan2 as ref

NAMES = ("bias_lrelu_gain_kernel",)


def calls(model: dict, batch: int, kind: str):
    if "fmap_base" not in model or kind != "forward":
        return []
    shapes = [(batch, int(model["w_dim"]))] * int(model["mapping_layers"])
    for res in ref.resolutions(model):
        shapes += [(batch, ref.channels(model, res), res, res)] * (1 if res == 4 else 2)
    return shapes


def cost(shape, itemsize: int):
    """(flops, bytes): about 5 operations an element; x read, y written."""
    numel = math.prod(shape)
    return 5.0 * numel, 2.0 * numel * itemsize
