"""The pixel norm and the leaky-ReLU + pixel norm forwards of G's
epilogues: y = z · rsqrt(mean_C(z²) + eps), z = x or leaky_relu(x)."""

import math

NAMES = ("norm_rows_vec_kernel", "norm_rows_kernel")


def g_forward_shapes(model: dict, batch: int):
    """[B, C, H, W] (or [B, C]) of each call in one G forward: the latent's
    and the 4×4 map's pixel norm, then every conv's epilogue."""
    d, scale = model["depths"], int(model["scale"])
    shapes = [(batch, int(model["latent_dim"])), (batch, d[0], 4, 4), (batch, d[0], 4, 4)]
    for i in range(1, scale + 1):
        res = 2 ** (i + 2)
        shapes += [(batch, d[i], res, res)] * 2
    return shapes


def calls(model: dict, batch: int, kind: str):
    """G forwards a step runs: z₁ and z₂ in a train step, one to sample."""
    forwards = 1 if kind == "forward" else 2
    return g_forward_shapes(model, batch) * forwards


def cost(shape, itemsize: int):
    """(flops, bytes): about 5 operations an element; x read, y written."""
    numel = math.prod(shape)
    return 5.0 * numel, 2.0 * numel * itemsize
