"""The plain reference of StyleGAN2's generator (Karras et al. 2020,
"Analyzing and Improving the Image Quality of StyleGAN", arXiv:1912.04958),
in float32 torch ops with no kernel, cache or fusion, following NVIDIA's
PyTorch code (github.com/NVlabs/stylegan2-ada-pytorch, `training/
networks.py`: `MappingNetwork`, `SynthesisNetwork` with the "skip"
architecture) and its parameter names.

    z [B, z_dim] → z·rsqrt(mean(z²) + 1e-8) → `mapping_layers` × (FC,
    lr multiplier 0.01, bias + lrelu·√2) → w, broadcast to every layer
    (ψ lerps w towards `mapping.w_avg`) →
    4×4 learned constant → per block of resolution r: conv0 (up 2 through
    the [1,3,3,1] filter; not in the 4² block), conv1, toRGB; the image is
    the sum of the toRGB outputs, each earlier sum upsampled 2× through the
    filter → [B, H, W, C] (NHWC, as the port returns it).

A conv layer: style s = affine(w) (bias initialised to 1); each sample's
weights s·w, demodulated to unit norm per output channel; a 3×3 conv; +
noise_const·noise_strength; bias + lrelu·√2 clamped to ±conv_clamp. A
toRGB: s = affine(w)/sqrt(C_in), 1×1 conv without demodulation, bias,
clamp. Channels at resolution r: min(2·fmap_base / r, fmap_max).

Departures from NVIDIA's code, none of which changes the function:
- the modulated convolution is computed explicitly per sample: one conv2d
  a sample with its own weights s·w·d, not NVIDIA's grouped convolution or
  its unfused x·s form;
- no fp16 pre-normalisation of the weights and styles (NVIDIA divides both
  by their largest entry when x is fp16): demodulation cancels it exactly,
  and the reference is float32;
- the FIR upsample is zero insertion, a pad and a depthwise conv2d with the
  flipped filter (NVIDIA's `upfirdn2d` reference path), and conv0 is that
  upsample followed by an unpadded 3×3 convolution with the weight flipped
  (NVIDIA's `conv2d_resample` with `flip_weight=False`), where NVIDIA runs
  a strided transposed convolution and then the filter;
- sampling only: noise_mode 'const', no truncation cutoff, no class
  label, no `w_avg` tracking.

`quant_f32` and `quant_low`, when given, round every conv or linear input
and weight on the way in: the first where the program computes in float32
(the mapping, the affines, the blocks below the reduced-precision ones),
the second in the `num_fp16_res` highest-resolution blocks. They serve the
benchmark's lower-precision control. TF32 is off while the reference runs.

This file imports nothing but torch. It is the oracle of the benchmark's
check and of the CPU tests (`tests/test_torch_stylegan2.py`), so both hold
the port to the same code.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-8
SLOPE = 0.2
SQRT2 = math.sqrt(2.0)
FIR = (1.0, 3.0, 3.0, 1.0)

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def resolutions(cfg: dict) -> List[int]:
    """The block resolutions, 4 up to cfg['resolution']."""
    return [2 ** i for i in range(2, int(math.log2(int(cfg["resolution"]))) + 1)]


def channels(cfg: dict, res: int) -> int:
    """min(2·fmap_base / res, fmap_max): TF's nf(log2(res) − 1)."""
    return min(2 * int(cfg["fmap_base"]) // res, int(cfg["fmap_max"]))


def reduced_from(cfg: dict) -> int:
    """The lowest resolution computed in reduced precision (NVIDIA's
    `fp16_resolution`)."""
    top = int(math.log2(int(cfg["resolution"])))
    return max(2 ** (top + 1 - int(cfg["num_fp16_res"])), 8)


def num_ws(cfg: dict) -> int:
    """One w a conv layer, and one for the last toRGB."""
    return 2 * len(resolutions(cfg))


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter and persistent buffer, NVIDIA's names."""
    z, w = int(cfg["z_dim"]), int(cfg["w_dim"])
    out: List[Tuple[str, Tuple[int, ...]]] = []
    for i in range(int(cfg["mapping_layers"])):
        fan_in = z if i == 0 else w
        out += [(f"mapping.fc{i}.weight", (w, fan_in)), (f"mapping.fc{i}.bias", (w,))]
    out.append(("mapping.w_avg", (w,)))
    img = int(cfg["img_channels"])
    prev = 0
    for res in resolutions(cfg):
        c = channels(cfg, res)
        block = f"synthesis.b{res}"
        if res == 4:
            out.append((f"{block}.const", (c, 4, 4)))
        for conv, cin in ((("conv1", c),) if res == 4 else (("conv0", prev), ("conv1", c))):
            name = f"{block}.{conv}"
            out += [(f"{name}.affine.weight", (cin, w)), (f"{name}.affine.bias", (cin,)),
                    (f"{name}.weight", (c, cin, 3, 3)), (f"{name}.noise_strength", ()),
                    (f"{name}.bias", (c,)), (f"{name}.noise_const", (res, res))]
        out += [(f"{block}.torgb.affine.weight", (c, w)), (f"{block}.torgb.affine.bias", (c,)),
                (f"{block}.torgb.weight", (img, c, 1, 1)), (f"{block}.torgb.bias", (img,))]
        prev = c
    return out


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return x if quant is None else quant(x)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * SLOPE)


def fully_connected(p: Params, name: str, x: torch.Tensor, lr_mul: float = 1.0,
                    quant: Quant = None) -> torch.Tensor:
    """x @ (W · lr_mul/sqrt(fan_in))ᵀ + b · lr_mul."""
    w, b = p[name + ".weight"], p[name + ".bias"]
    return F.linear(_q(x, quant), _q(w * (lr_mul / math.sqrt(w.shape[1])), quant), b * lr_mul)


def mapping(p: Params, z: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """z [B, z_dim] → w [B, w_dim]."""
    x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + EPS)
    for i in range(int(cfg["mapping_layers"])):
        x = lrelu(fully_connected(p, f"mapping.fc{i}", x, float(cfg["mapping_lr_multiplier"]),
                                  quant)) * SQRT2
    return x


def fir_filter(device) -> torch.Tensor:
    """The [1,3,3,1] filter's outer product, normalised to sum 1."""
    f = torch.tensor(FIR, dtype=torch.float32, device=device)
    f = torch.outer(f, f)
    return f / f.sum()


def upsample_fir(x: torch.Tensor, pad: Tuple[int, int]) -> torch.Tensor:
    """2× upsample: each sample followed by a zero along each axis, `pad`
    (before, after) zeros on each side, then the filter × 4 as a depthwise
    convolution (conv2d correlates, so the filter is flipped)."""
    n, c, h, w = x.shape
    up = torch.zeros((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    up[:, :, ::2, ::2] = x
    up = F.pad(up, [pad[0], pad[1], pad[0], pad[1]])
    f = (fir_filter(x.device) * 4.0).flip([0, 1])
    return F.conv2d(up, f[None, None].expand(c, 1, *f.shape), groups=c)


def modulated_conv(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor, *,
                   demodulate: bool, up: bool = False, quant: Quant = None) -> torch.Tensor:
    """Each sample b convolved with its own weights w · s_b (· d_b): a 3×3
    conv with padding 1, or after the filtered 2× upsample (pad 3, 2) an
    unpadded conv with the weight flipped; a 1×1 conv for a toRGB."""
    out = []
    for b in range(x.shape[0]):
        w = weight * styles[b].view(1, -1, 1, 1)
        if demodulate:
            w = w * torch.rsqrt(w.square().sum(dim=[1, 2, 3], keepdim=True) + EPS)
        xb = x[b:b + 1]
        pad = weight.shape[-1] // 2
        if up:
            xb, w, pad = upsample_fir(xb, (3, 2)), w.flip([2, 3]), 0
        out.append(F.conv2d(_q(xb, quant), _q(w, quant), padding=pad))
    return torch.cat(out)


def synthesis(p: Params, ws: torch.Tensor, cfg: dict, quant_f32: Quant = None,
              quant_low: Quant = None) -> torch.Tensor:
    """ws [B, num_ws, w_dim] → images [B, C, H, W]."""
    clamp = float(cfg["conv_clamp"])
    batch = ws.shape[0]
    low = reduced_from(cfg)
    x = img = None
    idx = 0
    for res in resolutions(cfg):
        block = f"synthesis.b{res}"
        quant = quant_low if res >= low else quant_f32
        if res == 4:
            x = p[f"{block}.const"].unsqueeze(0).expand(batch, -1, -1, -1)
        for conv in (("conv1",) if res == 4 else ("conv0", "conv1")):
            name = f"{block}.{conv}"
            styles = fully_connected(p, name + ".affine", ws[:, idx], quant=quant_f32)
            x = modulated_conv(x, p[name + ".weight"], styles, demodulate=True,
                               up=conv == "conv0", quant=quant)
            x = x + p[name + ".noise_const"] * p[name + ".noise_strength"]
            x = lrelu(x + p[name + ".bias"].view(1, -1, 1, 1)) * SQRT2
            x = x.clamp(-clamp, clamp)
            idx += 1
        if img is not None:
            img = upsample_fir(img, (2, 1))
        weight = p[f"{block}.torgb.weight"]
        styles = fully_connected(p, f"{block}.torgb.affine", ws[:, idx], quant=quant_f32)
        y = modulated_conv(x, weight, styles / math.sqrt(weight.shape[1]), demodulate=False,
                           quant=quant)
        y = (y + p[f"{block}.torgb.bias"].view(1, -1, 1, 1)).clamp(-clamp, clamp)
        img = y if img is None else img + y
    return img


def generator(p: Params, z: torch.Tensor, cfg: dict, psi: float = 1.0,
              quant_f32: Quant = None, quant_low: Quant = None) -> torch.Tensor:
    """z [B, z_dim] → images [B, H, W, C]."""
    w = mapping(p, z, cfg, quant_f32)
    if psi != 1.0:
        w = p["mapping.w_avg"].lerp(w, psi)
    ws = w.unsqueeze(1).expand(-1, num_ws(cfg), -1)
    return synthesis(p, ws, cfg, quant_f32, quant_low).permute(0, 2, 3, 1)
