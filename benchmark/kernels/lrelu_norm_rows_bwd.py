"""The backward of G's leaky-ReLU + pixel-norm epilogue:
dx = lrelu'(x) · (inv·g − z·inv³·mean_C(z·g))."""

import math

from benchmark.kernels import norm_rows_fwd

NAMES = ("lrelu_norm_rows_bwd_vec_kernel", "lrelu_norm_rows_bwd_kernel")


def calls(model: dict, batch: int, kind: str):
    """One call for every conv epilogue of the G phase's forward (the
    latent's and the 4×4 map's plain pixel norms go backward as torch ops)."""
    if kind == "forward":
        return []
    return norm_rows_fwd.g_forward_shapes(model, batch)[2:]


def cost(shape, itemsize: int):
    """(flops, bytes): about 10 operations an element; x and g read, dx written."""
    numel = math.prod(shape)
    return 10.0 * numel, 3.0 * numel * itemsize
