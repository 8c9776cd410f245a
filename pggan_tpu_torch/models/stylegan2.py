"""StyleGAN2's generator (Karras et al. 2020, arXiv:1912.04958), as NVIDIA's
PyTorch code builds it (github.com/NVlabs/stylegan2-ada-pytorch,
`training/networks.py`: `MappingNetwork`, `SynthesisNetwork` with the
"skip" architecture), with its parameter names, for sampling.

  z [B, z_dim] → z·rsqrt(mean(z²) + 1e-8) → `mapping_layers` × (FC, lr
    multiplier 0.01, bias + lrelu·√2: the `bias_lrelu_gain` kernel) → w;
    ψ lerps w towards the `w_avg` buffer (the identity at ψ = 1); w is
    broadcast to every layer
  → a learned 4×4 constant → per block of resolution r: conv0 (2× up
    through the [1,3,3,1] FIR filter; not in the 4² block), conv1, toRGB
  → the image, the sum of the toRGB outputs with each earlier sum
    upsampled through the filter → [B, H, W, C] f32 (NHWC, as the PGGAN
    generator returns it).

A conv layer: style s = affine(w) (bias initialised to 1) →
`ops.modulated.modulated_conv2d` (modulate, conv, then the epilogue:
demodulate, + the layer's constant noise × its learned strength, bias +
lrelu·√2, clamp conv_clamp). When sampling (no autograd), the epilogue is
one pass of the `bias_lrelu_gain` kernel over the conv's output
(`kernels.modconv_epilogue`, d, noise and bias in f32); under autograd it is
`addcmul` and then `bias_act`, the clamped `bias_lrelu_gain` kernel. A
toRGB: s = affine(w)/sqrt(C_in), a 1×1 modulated conv without
demodulation, `bias_act(linear, clamp conv_clamp)`. Channels at
resolution r: min(2·fmap_base / r, fmap_max); config-f (fmap_base 32768)
gives 512 up to 128², then 256, 128, 64.

Precision: the `num_fp16_res` highest-resolution blocks compute in the
forward's `compute_dtype` (bfloat16 by default, where NVIDIA uses fp16; bf16 has
f32's range, so NVIDIA's fp16 pre-normalisation of weights and styles is
not needed), the others, the mapping and every affine in float32; weights
and styles stay float32. Float32 means float32: the mapping's and the
synthesis's forwards turn TF32 off for cuDNN's convolutions and cuBLAS's
matmuls while they run (`float32_without_tf32`; PyTorch's default lets
cuDNN compute float32 convolutions in TF32). Activations are channels_last.

The mapping is a `stylegan2.mapping` profiler range, each modulated conv a
`stylegan2.modconv` range and each FIR upsample (conv0's and the image's) a
`stylegan2.resample` range. Weights are drawn with NVIDIA's initialisation
from a generator seeded per layer, except the noise strengths, which NVIDIA
starts at 0 and which are drawn N(0, 0.1²) here so that the noise path
carries weight in a network that was never trained.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from pggan_tpu_torch.ops.basic import bias_act
from pggan_tpu_torch.ops.equalized import component_rng, he_constant
from pggan_tpu_torch.ops.kernels import SQRT2
from pggan_tpu_torch.ops.modulated import RESAMPLE_SPAN, modulated_conv2d
from pggan_tpu_torch.ops.resample import setup_filter, upsample2d
from pggan_tpu_torch.utils.checkpoint import check_key_set

__all__ = ["StyleGAN2Generator", "MappingNetwork", "SynthesisNetwork", "params_to_arrays",
           "load_params", "float32_without_tf32", "MAPPING_SPAN"]

MAPPING_SPAN = "stylegan2.mapping"
NET_SG2 = 2                       # network id of the per-layer seeds
NOISE_STRENGTH_STD = 0.1
FIR = [1, 3, 3, 1]


@contextlib.contextmanager
def float32_without_tf32():
    """TF32 off for cuDNN's convolutions and cuBLAS's matmuls inside the
    block; both settings are restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def weight_gain(fan_in: int, lr_mul: float = 1.0) -> float:
    """NVIDIA's run-time weight gain lr_mul / sqrt(fan_in): He's constant
    without its √2, which StyleGAN2 puts in bias_act's gain instead."""
    return he_constant(fan_in, lr_mul) / SQRT2


class FullyConnected(nn.Module):
    """x @ (W · lr_mul/sqrt(in))ᵀ + b · lr_mul, then `bias_act`; W is
    stored N(0, 1)/lr_mul and b at `bias_init` (NVIDIA's
    `FullyConnectedLayer`). Always float32."""

    def __init__(self, in_features: int, out_features: int, *, lr_mul: float = 1.0,
                 bias_init: float = 0.0, activation: str = "linear",
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn((out_features, in_features), generator=generator) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init)))
        self.gain = weight_gain(in_features, lr_mul)
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight * self.gain, self.bias * self.lr_mul
        if self.activation == "linear":
            return torch.addmm(b.unsqueeze(0), x, w.t())
        return bias_act(x.matmul(w.t()), b, act=self.activation)


class MappingNetwork(nn.Module):
    def __init__(self, *, z_dim: int, w_dim: int, num_layers: int, lr_mul: float,
                 seed: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"fc{i}", FullyConnected(
                z_dim if i == 0 else w_dim, w_dim, lr_mul=lr_mul, activation="lrelu",
                generator=component_rng(seed, NET_SG2, 0, i)))
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z: torch.Tensor, psi: float = 1.0) -> torch.Tensor:
        """z [B, z_dim] → w [B, w_dim], f32."""
        with record_function(MAPPING_SPAN), float32_without_tf32():
            x = z.float()
            x = x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)
            for i in range(self.num_layers):
                x = getattr(self, f"fc{i}")(x)
            if psi != 1.0:
                x = self.w_avg.lerp(x, psi)
            return x


class SynthesisLayer(nn.Module):
    """affine → modulated 3×3 conv (2× up for conv0) → demodulation + noise
    + bias → lrelu·√2, clamped (the epilogue inside `modulated_conv2d`)."""

    def __init__(self, in_ch: int, out_ch: int, *, w_dim: int, resolution: int, up: int,
                 conv_clamp: Optional[float], generator: torch.Generator):
        super().__init__()
        self.affine = FullyConnected(w_dim, in_ch, bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(torch.randn((out_ch, in_ch, 3, 3), generator=generator))
        self.noise_strength = nn.Parameter(
            torch.randn((), generator=generator) * NOISE_STRENGTH_STD)
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer("noise_const",
                             torch.randn((resolution, resolution), generator=generator))
        self.up = up
        self.conv_clamp = conv_clamp

    def forward(self, x: torch.Tensor, w: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return modulated_conv2d(x, self.weight, self.affine(w), up=self.up, padding=1,
                                resample_filter=f,
                                noise=self.noise_const * self.noise_strength,
                                flip_weight=self.up == 1, act="lrelu", bias=self.bias,
                                clamp=self.conv_clamp)


class ToRGB(nn.Module):
    def __init__(self, in_ch: int, img_channels: int, *, w_dim: int,
                 conv_clamp: Optional[float], generator: torch.Generator):
        super().__init__()
        self.affine = FullyConnected(w_dim, in_ch, bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(torch.randn((img_channels, in_ch, 1, 1), generator=generator))
        self.bias = nn.Parameter(torch.zeros(img_channels))
        self.gain = 1.0 / math.sqrt(in_ch)
        self.conv_clamp = conv_clamp

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = modulated_conv2d(x, self.weight, self.affine(w) * self.gain, demodulate=False)
        return bias_act(x, self.bias.to(x.dtype), clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, w_dim: int, resolution: int,
                 img_channels: int, reduced: bool, conv_clamp: Optional[float], seed: int):
        super().__init__()
        rng = component_rng(seed, NET_SG2, 1, resolution)
        self.resolution = resolution
        self.reduced = reduced
        if in_ch == 0:
            self.const = nn.Parameter(torch.randn((out_ch, resolution, resolution),
                                                  generator=rng))
        else:
            self.conv0 = SynthesisLayer(in_ch, out_ch, w_dim=w_dim, resolution=resolution,
                                        up=2, conv_clamp=conv_clamp, generator=rng)
        self.conv1 = SynthesisLayer(out_ch, out_ch, w_dim=w_dim, resolution=resolution,
                                    up=1, conv_clamp=conv_clamp, generator=rng)
        self.torgb = ToRGB(out_ch, img_channels, w_dim=w_dim, conv_clamp=conv_clamp,
                           generator=rng)
        self.num_conv = 1 if in_ch == 0 else 2
        self.register_buffer("resample_filter", setup_filter(FIR, device="cpu"),
                             persistent=False)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                ws: List[torch.Tensor], dtype: torch.dtype):
        dt = dtype if self.reduced else torch.float32
        f = self.resample_filter
        if x is None:
            x = self.const.to(dt).unsqueeze(0).expand(ws[0].shape[0], -1, -1, -1)
            x = x.contiguous(memory_format=torch.channels_last)
            x = self.conv1(x, ws[0], f)
        else:
            x = self.conv0(x.to(dt), ws[0], f)
            x = self.conv1(x, ws[1], f)
        if img is not None:
            with record_function(RESAMPLE_SPAN):
                img = upsample2d(img, f)
        y = self.torgb(x, ws[self.num_conv]).float()
        return x, y if img is None else img + y


class SynthesisNetwork(nn.Module):
    def __init__(self, *, w_dim: int, resolution: int, img_channels: int, fmap_base: int,
                 fmap_max: int, num_fp16_res: int, conv_clamp: Optional[float], seed: int):
        super().__init__()
        top = int(math.log2(resolution))
        if 2 ** top != resolution or resolution < 4:
            raise ValueError(f"resolution must be a power of 2 >= 4, got {resolution}")
        self.resolutions = [2 ** i for i in range(2, top + 1)]
        reduced_from = max(2 ** (top + 1 - num_fp16_res), 8)
        prev = 0
        for res in self.resolutions:
            ch = min(2 * fmap_base // res, fmap_max)
            setattr(self, f"b{res}", SynthesisBlock(
                prev, ch, w_dim=w_dim, resolution=res, img_channels=img_channels,
                reduced=res >= reduced_from, conv_clamp=conv_clamp, seed=seed))
            prev = ch
        self.num_ws = 2 * len(self.resolutions)

    def forward(self, ws: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """ws [B, num_ws, w_dim] → images [B, C, H, W] f32, channels_last.
        Block r takes its convs' ws and, for its toRGB, the next one (which
        the next block's conv0 takes too), as NVIDIA's `w_idx` walks them."""
        per_layer = ws.unbind(dim=1)
        x = img = None
        idx = 0
        with float32_without_tf32():
            for res in self.resolutions:
                block = getattr(self, f"b{res}")
                x, img = block(x, img, per_layer[idx:idx + block.num_conv + 1], dtype)
                idx += block.num_conv
        return img


class StyleGAN2Generator(nn.Module):
    """Mapping and synthesis; `forward(z, psi)` → [B, H, W, C] f32."""

    def __init__(self, *, z_dim: int = 512, w_dim: int = 512, mapping_layers: int = 8,
                 mapping_lr_multiplier: float = 0.01, resolution: int = 1024,
                 fmap_base: int = 32768, fmap_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0, img_channels: int = 3, seed: int = 0):
        super().__init__()
        self.z_dim = int(z_dim)
        self.resolution = int(resolution)
        self.mapping = MappingNetwork(z_dim=z_dim, w_dim=w_dim, num_layers=mapping_layers,
                                      lr_mul=mapping_lr_multiplier, seed=seed)
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, resolution=resolution, img_channels=img_channels,
            fmap_base=fmap_base, fmap_max=fmap_max, num_fp16_res=num_fp16_res,
            conv_clamp=None if conv_clamp is None else float(conv_clamp), seed=seed)

    def forward(self, z: torch.Tensor, psi: float = 1.0, *,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """`compute_dtype` is the precision of the `num_fp16_res` highest
        resolutions; float32 computes the whole network in float32."""
        w = self.mapping(z, psi)
        ws = w.unsqueeze(1).expand(-1, self.synthesis.num_ws, -1)
        return self.synthesis(ws, compute_dtype).permute(0, 2, 3, 1)


# The npz checkpoint (`utils/checkpoint.py`) keys a tensor by its
# state_dict name with '/' for '.': `mapping/fc0/weight`,
# `synthesis/b8/conv0/noise_const`, ...

def params_to_arrays(module: nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter and persistent buffer as a numpy copy."""
    return {name.replace(".", "/"): t.detach().cpu().numpy().copy()
            for name, t in module.state_dict().items()}


def load_params(module: nn.Module, arrays: Dict[str, np.ndarray]) -> nn.Module:
    """Copy `arrays` into the module strictly: the key sets must match
    (KeyError) and every shape must agree (ValueError)."""
    own = {name.replace(".", "/"): t for name, t in module.state_dict().items()}
    check_key_set(own, arrays)
    with torch.no_grad():
        for key, target in own.items():
            src = torch.as_tensor(np.asarray(arrays[key]))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch for {key}: checkpoint {tuple(src.shape)} "
                                 f"vs model {tuple(target.shape)}")
            target.copy_(src)
    return module
