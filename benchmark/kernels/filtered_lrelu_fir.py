"""The FIR stages of StyleGAN3's filtered leaky ReLU (`csrc/upfirdn2d.cu`'s
separable kernels, which serve its long 1-D filters at up 2 or 4 and down
2): per conv layer an up stage (zero insertion ×2 or ×4 through 12 or 24
taps an axis, the layer's pads) from the conv's output to the activation's
2× rate, and a down stage (12 taps, ×2 decimation) to the layer's output.

Its calls are a StyleGAN3 forward's 28 (two for each of the 14 conv layers;
the toRGB has none); a model without `num_critical` (PGGAN, StyleGAN2)
calls none of these kernels. A shape is (N, C, H, W, OH, OW, taps, up,
down, bytes an element): each call carries its own element size, since the
layers below the reduced-precision ones run in float32. `cost` counts each
input read once and each output written once, and the separable form's
multiply-adds: along x at the input's rows, then along y."""

import math

from benchmark.reference import stylegan3 as ref

NAMES = ("upfirdn2d_sep_up_kernel", "upfirdn2d_sep_down_kernel")


def calls(model: dict, batch: int, kind: str):
    if "num_critical" not in model or kind != "forward":
        return []
    low = 2 if model.get("compute_dtype") == "bfloat16" else 4
    shapes = []
    for layer in ref.schedule(model):
        if layer["torgb"]:
            continue
        size = 4 if not layer["reduced"] else low
        conv = layer["in_size"] + layer["kernel"] - 1
        x0, x1, _, _ = layer["padding"]
        tmp = conv * layer["up"] + x0 + x1 - layer["up_taps"] + 1
        shapes.append((batch, layer["channels"], conv, conv, tmp, tmp, layer["up_taps"],
                       layer["up"], 1, size))
        shapes.append((batch, layer["channels"], tmp, tmp, layer["size"], layer["size"],
                       layer["down_taps"], 1, layer["down"], size))
    return shapes


def cost(shape, itemsize: int):
    """(flops, bytes) of one call; the call's own element size stands in
    for the cell's `itemsize`."""
    n, c, h, w, oh, ow, taps, up, down, size = shape
    along_x = h * ow * taps / up
    along_y = oh * ow * taps / up
    flops = 2.0 * n * c * (along_x + along_y)
    return flops, float(n * c * (h * w + oh * ow) * size)
