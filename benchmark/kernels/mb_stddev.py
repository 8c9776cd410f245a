"""The minibatch-stddev statistic of D: per group of 4 samples, the mean
over C·H·W of sqrt(unbiased variance + eps)."""

import math

NAMES = ("mb_stddev_kernel",)
GROUP = 4


def calls(model: dict, batch: int, kind: str):
    """[N, d0, 4, 4] of each D forward: with R1 the real forward, the fake
    one and the G phase's; without, reals and fakes as one 2B forward and
    the G phase's; none to sample."""
    d0 = model["depths"][0]
    if kind == "r1":
        return [(batch, d0, 4, 4)] * 3
    if kind == "plain":
        return [(2 * batch, d0, 4, 4), (batch, d0, 4, 4)]
    return []


def cost(shape, itemsize: int):
    """(flops, bytes): about 4 operations an element; x read, one f32 a
    group written."""
    numel = math.prod(shape)
    return 4.0 * numel, float(numel * itemsize + 4 * (shape[0] // GROUP))
