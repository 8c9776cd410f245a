"""The plain reference of the progressive GAN (Karras et al. 2018,
arXiv:1710.10196), in f32 torch ops with no kernel, cache or fusion: the
generator, the discriminator and their layer list.

It follows the published network and the reference implementation's
conventions (yukyeongleee/pggan), which the program keeps:

- equalized learning rate: weights drawn N(0, 1), He's constant
  c = sqrt(2 / fan_in) applied at run time to the weight and to the bias,
  `conv(x, w·c) + b·c`;
- G: pixel norm of the latent; a linear layer to 16·d0 features, leaky ReLU,
  an NCHW-major view to [B, d0, 4, 4], pixel norm; a 3×3 conv; each block a
  nearest 2× upscale and two 3×3 convs, each conv followed by leaky ReLU
  and pixel norm; 1×1 toRGB of the last block, faded at scale ≥ 1 with the
  2× upscaled toRGB of the block before: (1-α)·prev + α·out. Output NHWC;
- D: 1×1 fromRGB + leaky ReLU; each block, outermost first, two 3×3 convs
  with leaky ReLU then a 2× average pool, and after the first block the
  fade (1-α)·lrelu(fromRGB[-2](pool(x))) + α·y; the minibatch-stddev
  channel (groups of min(N, 4) consecutive samples, unbiased variance,
  sqrt(var + 1e-8), averaged over C, H, W); a 3×3 conv on d0+1 channels,
  leaky ReLU, NCHW-major flatten, a linear layer to d0 with leaky ReLU and
  the linear decision layer.

The layer names are those the benchmark gives the weights under.

`quant`, when given, rounds every conv or linear input and weight on the way
in, and the gradient flowing back through it: the lower-precision control,
the precision below the one the configuration states. `tf32` (for float32)
keeps 10 bits of mantissa, as the tensor cores' TF32 reads an operand;
`fp8` (for bfloat16) is the fp8 training recipe, e4m3 forward and e5m2
backward, each tensor scaled by its own amax onto the format's largest
value (Micikevicius et al. 2022). A second derivative passes the rounding
as the first does, so R1's double backward runs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-8
SLOPE = 0.2
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """`rounded`'s values with x's derivative, 1: a second derivative passes
    the rounding as the first does."""
    return x + (rounded - x.detach())


def _tf32_values(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits (to nearest, ties away from
    zero), kept in float32."""
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


def _fp8_values(x: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """x cast to `dtype` under a per-tensor scale that maps its amax onto
    the format's largest value, and back."""
    xd = x.detach().float()
    scale = largest / xd.abs().amax().clamp_min(1e-30)
    return ((xd * scale).to(dtype).float() / scale).to(x.dtype)


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _tf32_values(x)

    @staticmethod
    def backward(ctx, g):
        return _through(g, _tf32_values(g))


class _Fp8(torch.autograd.Function):
    """Forward: x in float8 e4m3. Backward: the incoming gradient in float8
    e5m2 (the pair of fp8 training formats)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_values(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _through(g, _fp8_values(g, torch.float8_e5m2, FP8_E5M2_MAX))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """The float32 control's rounding of a conv or linear operand."""
    return _Tf32.apply(x)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The bfloat16 control's rounding of a conv or linear operand."""
    return _Fp8.apply(x)


QUANTS = {"float32": None, "tf32": tf32, "fp8": fp8}
# the control of each precision a configuration can state: the one below it
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def g_layers(depths: Sequence[int], scale: int, latent_dim: int,
             channels: int = 3) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, weight shape) of every layer of G at `scale`; each has a bias
    of its first dimension."""
    d = list(depths)
    out = [("format", (16 * d[0], latent_dim)), ("first_conv", (d[0], d[0], 3, 3))]
    for i in range(scale):
        out += [(f"blocks.{i}.conv0", (d[i + 1], d[i], 3, 3)),
                (f"blocks.{i}.conv1", (d[i + 1], d[i + 1], 3, 3))]
    out += [(f"torgb.{i}", (channels, d[i], 1, 1)) for i in range(scale + 1)]
    return out


def d_layers(depths: Sequence[int], scale: int,
             channels: int = 3) -> List[Tuple[str, Tuple[int, ...]]]:
    d = list(depths)
    out = [(f"fromrgb.{i}", (d[i], channels, 1, 1)) for i in range(scale + 1)]
    for j in range(scale):
        out += [(f"blocks.{j}.conv0", (d[j + 1], d[j + 1], 3, 3)),
                (f"blocks.{j}.conv1", (d[j], d[j + 1], 3, 3))]
    out += [("last_conv", (d[0], d[0] + 1, 3, 3)), ("last_linear", (d[0], 16 * d[0])),
            ("decision", (1, d[0]))]
    return out


def _he(shape: Tuple[int, ...]) -> float:
    return math.sqrt(2.0 / math.prod(shape[1:]))


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return x if quant is None else quant(x)


def conv(p: Params, name: str, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    w, b = p[name + ".weight"], p[name + ".bias"]
    c = _he(tuple(w.shape))
    return F.conv2d(_q(x, quant), _q(w * c, quant), b * c, padding=w.shape[-1] // 2)


def linear(p: Params, name: str, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    w, b = p[name + ".weight"], p[name + ".bias"]
    c = _he(tuple(w.shape))
    return F.linear(_q(x, quant), _q(w * c, quant), b * c)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * SLOPE)


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + EPS)


def up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def down2(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def fade(low: torch.Tensor, high: torch.Tensor, alpha: float) -> torch.Tensor:
    return (1.0 - alpha) * low + alpha * high


def generator(p: Params, z: torch.Tensor, alpha: float, scale: int,
              d0: int, quant: Quant = None) -> torch.Tensor:
    """[B, latent] → [B, H, W, 3]."""
    x = pixel_norm(z)
    x = lrelu(linear(p, "format", x, quant)).reshape(z.shape[0], d0, 4, 4)
    x = pixel_norm(x)
    x = pixel_norm(lrelu(conv(p, "first_conv", x, quant)))
    prev = x
    for i in range(scale):
        prev = x
        x = pixel_norm(lrelu(conv(p, f"blocks.{i}.conv0", up2(x), quant)))
        x = pixel_norm(lrelu(conv(p, f"blocks.{i}.conv1", x, quant)))
    out = conv(p, f"torgb.{scale}", x, quant)
    if scale >= 1:
        out = fade(up2(conv(p, f"torgb.{scale - 1}", prev, quant)), out, alpha)
    return out.permute(0, 2, 3, 1)


def minibatch_stddev(x: torch.Tensor, group: int = 4) -> torch.Tensor:
    n, _, h, w = x.shape
    sg = min(n, group)
    if n % sg:
        sg = n
    if sg <= 1:
        stat = torch.zeros(n, dtype=x.dtype, device=x.device)
    else:
        var = x.reshape(n // sg, sg, -1).var(dim=1, unbiased=True)
        stat = torch.sqrt(var + EPS).mean(dim=-1).repeat_interleave(sg)
    return torch.cat([x, stat.view(n, 1, 1, 1).expand(n, 1, h, w)], dim=1)


def discriminator(p: Params, images: torch.Tensor, alpha: float, scale: int,
                  quant: Quant = None) -> torch.Tensor:
    """[B, H, W, 3] → logits [B, 1]."""
    x = images.permute(0, 3, 1, 2)
    if scale >= 1:
        x_down = lrelu(conv(p, f"fromrgb.{scale - 1}", down2(x), quant))
    y = lrelu(conv(p, f"fromrgb.{scale}", x, quant))
    for pos, j in enumerate(reversed(range(scale))):
        y = lrelu(conv(p, f"blocks.{j}.conv0", y, quant))
        y = down2(lrelu(conv(p, f"blocks.{j}.conv1", y, quant)))
        if pos == 0:
            y = fade(x_down, y, alpha)
    y = minibatch_stddev(y)
    y = lrelu(conv(p, "last_conv", y, quant))
    y = lrelu(linear(p, "last_linear", y.reshape(y.shape[0], -1), quant))
    return linear(p, "decision", y, quant)
