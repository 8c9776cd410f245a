"""StyleGAN3-T's generator (Karras et al. 2021, "Alias-Free Generative
Adversarial Networks", arXiv:2106.12423), as NVIDIA's PyTorch code builds it
(github.com/NVlabs/stylegan3, `training/networks_stylegan3.py`:
`MappingNetwork`, `SynthesisInput`, `SynthesisLayer`, `SynthesisNetwork`;
`train.py --cfg=stylegan3-t`), with its parameter names, for sampling.

  z [B, z_dim] → StyleGAN2's mapping (`models/stylegan2.MappingNetwork`: z
    normalised in torch ops, `mapping_layers` FCs with lr multiplier 0.01
    and lrelu·√2; ψ lerps towards `w_avg`) → w, broadcast to num_layers + 2
    ws
  → the input layer: `channels[0]` fixed Fourier features, whose
    frequencies and phases an affine map of ws[0] rotates and translates
    per sample, sampled on a `sizes[0]`² grid at sampling rate
    `sampling_rates[0]`, then a channel mix
  → layers L0 … L{num_layers − 1}: affine(w) → a modulated 3×3 conv
    (NVIDIA's pre-normalisation of the weights and styles, demodulation, an
    input gain rsqrt(magnitude_ema), padding 2, so the map grows by 2 a
    side) → x·d + b → the filtered leaky ReLU (`ops.composite.
    filtered_lrelu`: zero insertion ×up through the layer's Kaiser low-pass
    filter, lrelu(0.2)·√2 clamped to ±conv_clamp, low-pass and ×down
    decimation)
  → L{num_layers}: a modulated 1×1 toRGB without demodulation (styles ×
    1/√C_in, the input gain), bias, clamp, then × output_scale
  → [B, H, W, C] f32 (NHWC, as the PGGAN and StyleGAN2 generators return).

Each layer's cutoff, stopband, sampling rate and size follow NVIDIA's
geometric schedule (`layer_schedule`): every layer runs its activation at
2× the higher of its input and output rates, so a layer that doubles the
rate up-samples ×4 and decimates ×2, and the last `num_critical` layers are
critically sampled. The filters are NVIDIA's `design_lowpass_filter`
(scipy's `firwin` with a Kaiser window, written here in numpy), applied
separably; they are derived from the configuration and are not part of the
checkpoint. Channels: rint(min(channel_base / 2 / cutoff, channel_max)).

A conv layer's epilogue x·d + b is one pass of the bias-act kernel when
sampling (`ops.modulated`'s `linear` epilogue); the filtered leaky ReLU's
two resampling stages are the upfirdn2d kernels (`csrc/upfirdn2d.cu`'s
separable ones on StyleGAN3's 1-D filters) and its activation the clamped
`bias_lrelu_gain` kernel.

Precision: the layers whose sampling rate × 2^num_fp16_res exceeds the
resolution compute in the forward's `compute_dtype` (bfloat16 by default,
where NVIDIA uses fp16); the others, the mapping, the input layer and every
affine in float32 with TF32 off (`stylegan2.float32_without_tf32`). Weights
stay float32. Activations are channels_last.

The mapping is a `stylegan2.mapping` profiler range, the input layer a
`stylegan3.input` range, each modulated conv a `stylegan2.modconv` range and
each filtered leaky ReLU a `stylegan3.filtered_lrelu` range. Weights are
drawn with NVIDIA's initialisation from a generator seeded per layer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from pggan_tpu_torch.ops.composite import filtered_lrelu
from pggan_tpu_torch.ops.equalized import component_rng
from pggan_tpu_torch.ops.kernels import SQRT2
from pggan_tpu_torch.ops.modulated import modulated_conv2d
from pggan_tpu_torch.models.stylegan2 import (FullyConnected, MappingNetwork,  # noqa: F401
                                              float32_without_tf32, load_params,
                                              params_to_arrays)

__all__ = ["StyleGAN3Generator", "SynthesisNetwork", "SynthesisInput", "SynthesisLayer",
           "design_lowpass_filter", "layer_schedule", "params_to_arrays", "load_params",
           "INPUT_SPAN"]

INPUT_SPAN = "stylegan3.input"
NET_SG3 = 3                       # network id of the per-layer seeds


def design_lowpass_filter(numtaps: int, cutoff: float, width: float,
                          fs: float) -> Optional[np.ndarray]:
    """NVIDIA's separable Kaiser low-pass filter: `scipy.signal.firwin(
    numtaps, cutoff, width=width, fs=fs)` in numpy, float64, summing to 1;
    None for one tap (the identity)."""
    if numtaps == 1:
        return None
    nyq = fs / 2.0
    atten = 2.285 * (numtaps - 1) * math.pi * (width / nyq) + 7.95    # scipy's kaiser_atten
    if atten > 50:                                                    # scipy's kaiser_beta
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    c = cutoff / nyq
    h = c * np.sinc(c * m) * np.kaiser(numtaps, beta)
    return h / h.sum()


def layer_schedule(*, resolution: int = 1024, channel_base: int = 32768, channel_max: int = 512,
                   num_layers: int = 14, num_critical: int = 2, first_cutoff: float = 2.0,
                   first_stopband: float = 2 ** 2.1, last_stopband_rel: float = 2 ** 0.3,
                   margin_size: int = 10, num_fp16_res: int = 4, img_channels: int = 3,
                   conv_kernel: int = 3, filter_size: int = 6, lrelu_upsampling: int = 2,
                   **_unused) -> Dict[str, list]:
    """NVIDIA's `SynthesisNetwork` and `SynthesisLayer` schedule, per layer
    0 … num_layers (the last the toRGB): `cutoffs`, `stopbands`,
    `sampling_rates`, `half_widths`, `sizes`, `channels`, and for each layer
    the rate of its activation (`tmp_rates`), its `up` and `down` factors,
    filter `up_taps` and `down_taps`, `padding` (x0, x1, y0, y1) around the
    up stage, `critical` and `reduced` (computed in the reduced precision)."""
    last_cutoff = resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, resolution))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + margin_size * 2
    sizes[-2:] = resolution
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = img_channels
    out = {"cutoffs": cutoffs.tolist(), "stopbands": stopbands.tolist(),
           "sampling_rates": [int(r) for r in rates], "half_widths": half_widths.tolist(),
           "sizes": [int(s) for s in sizes], "channels": [int(c) for c in channels],
           "tmp_rates": [], "up": [], "down": [], "up_taps": [], "down_taps": [],
           "padding": [], "critical": [], "reduced": []}
    for idx in range(num_layers + 1):
        prev = max(idx - 1, 0)
        torgb = idx == num_layers
        kernel = 1 if torgb else conv_kernel
        tmp_rate = max(rates[prev], rates[idx]) * (1 if torgb else lrelu_upsampling)
        up = int(np.rint(tmp_rate / rates[prev]))
        down = int(np.rint(tmp_rate / rates[idx]))
        up_taps = filter_size * up if up > 1 and not torgb else 1
        down_taps = filter_size * down if down > 1 and not torgb else 1
        total = (sizes[idx] - 1) * down + 1 - (sizes[prev] + kernel - 1) * up
        total += up_taps + down_taps - 2
        lo = (total + up) // 2
        hi = total - lo
        out["tmp_rates"].append(int(tmp_rate))
        out["up"].append(up)
        out["down"].append(down)
        out["up_taps"].append(up_taps)
        out["down_taps"].append(down_taps)
        out["padding"].append((int(lo), int(hi), int(lo), int(hi)))
        out["critical"].append(idx >= num_layers - num_critical)
        out["reduced"].append(bool(rates[idx] * 2 ** num_fp16_res > resolution))
    return out


def _filter_buffer(taps: Optional[np.ndarray]) -> torch.Tensor:
    """A designed filter as an f32 tensor; [] (no filter) for the identity."""
    return torch.zeros(0) if taps is None else torch.as_tensor(taps, dtype=torch.float32)


class SynthesisInput(nn.Module):
    """Fourier features: `channels` frequencies drawn uniformly in a disc of
    radius `bandwidth`, rotated and translated per sample by affine(w), as
    sin(2π(grid·freqs + phases))·amplitudes on a size² grid at
    `sampling_rate`, then mixed by `weight` / √channels."""

    def __init__(self, *, w_dim: int, channels: int, size: int, sampling_rate: float,
                 bandwidth: float, generator: torch.Generator):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = float(sampling_rate), float(bandwidth)
        freqs = torch.randn((channels, 2), generator=generator)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp().pow(0.25)) * bandwidth
        phases = torch.rand((channels,), generator=generator) - 0.5
        self.weight = nn.Parameter(torch.randn((channels, channels), generator=generator))
        self.affine = FullyConnected(w_dim, 4, generator=generator)
        with torch.no_grad():                 # NVIDIA: weight_init 0, bias_init [1, 0, 0, 0]
            self.affine.weight.zero_()
            self.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        self.register_buffer("transform", torch.eye(3, 3))
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", phases)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        """w [B, w_dim] f32 → [B, channels, size, size] f32, channels_last."""
        with record_function(INPUT_SPAN):
            batch = w.shape[0]
            t = self.affine(w)                                  # (r_c, r_s, t_x, t_y)
            t = t / t[:, :2].norm(dim=1, keepdim=True)
            m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat([batch, 1, 1])
            m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
            m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat([batch, 1, 1])
            m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
            transforms = m_r @ m_t @ self.transform.unsqueeze(0)
            freqs = self.freqs.unsqueeze(0)
            phases = self.phases.unsqueeze(0) + (freqs @ transforms[:, :2, 2:]).squeeze(2)
            freqs = freqs @ transforms[:, :2, :2]
            amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                          / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
            theta = torch.eye(2, 3, device=w.device)
            theta[0, 0] = theta[1, 1] = 0.5 * self.size / self.sampling_rate
            grids = F.affine_grid(theta.unsqueeze(0), [1, 1, self.size, self.size],
                                  align_corners=False)
            x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
            x = torch.sin((x + phases.unsqueeze(1).unsqueeze(2)) * (2 * math.pi))
            x = x * amplitudes.unsqueeze(1).unsqueeze(2)
            x = x @ (self.weight / math.sqrt(self.channels)).t()    # [B, H, W, C]
            return x.permute(0, 3, 1, 2)


class SynthesisLayer(nn.Module):
    """affine → modulated conv (pre-normalised, demodulated, input gain) →
    x·d + b → filtered leaky ReLU; or, as the toRGB, a 1×1 modulated conv
    without demodulation → bias, clamp."""

    def __init__(self, *, w_dim: int, torgb: bool, reduced: bool, in_channels: int,
                 out_channels: int, up: int, down: int, up_filter: Optional[np.ndarray],
                 down_filter: Optional[np.ndarray], padding, conv_kernel: int,
                 conv_clamp: Optional[float], generator: torch.Generator):
        super().__init__()
        self.torgb, self.reduced = torgb, reduced
        self.up, self.down, self.padding = up, down, tuple(padding)
        self.conv_kernel = 1 if torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(torch.randn(
            (out_channels, in_channels, self.conv_kernel, self.conv_kernel), generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("magnitude_ema", torch.ones(()))
        self.register_buffer("up_filter", _filter_buffer(up_filter), persistent=False)
        self.register_buffer("down_filter", _filter_buffer(down_filter), persistent=False)
        self.weight_gain = 1.0 / math.sqrt(in_channels * self.conv_kernel ** 2)

    def forward(self, x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype if self.reduced else torch.float32)
        styles = self.affine(w)
        input_gain = self.magnitude_ema.rsqrt()
        if self.torgb:
            x = modulated_conv2d(x, self.weight, styles * self.weight_gain, demodulate=False,
                                 input_gain=input_gain)
            return filtered_lrelu(x, b=self.bias, gain=1.0, slope=1.0, clamp=self.conv_clamp)
        x = modulated_conv2d(x, self.weight, styles, padding=self.conv_kernel - 1,
                             prenormalize=True, input_gain=input_gain, act="linear",
                             bias=self.bias)
        fu = self.up_filter if self.up_filter.numel() else None
        fd = self.down_filter if self.down_filter.numel() else None
        return filtered_lrelu(x, fu, fd, up=self.up, down=self.down, padding=self.padding,
                              gain=SQRT2, slope=0.2, clamp=self.conv_clamp)


class SynthesisNetwork(nn.Module):
    def __init__(self, *, w_dim: int, resolution: int, img_channels: int, channel_base: int,
                 channel_max: int, num_layers: int, num_critical: int, first_cutoff: float,
                 first_stopband: float, last_stopband_rel: float, margin_size: int,
                 output_scale: float, num_fp16_res: int, conv_clamp: Optional[float],
                 conv_kernel: int, filter_size: int, lrelu_upsampling: int, seed: int):
        super().__init__()
        s = layer_schedule(resolution=resolution, channel_base=channel_base,
                           channel_max=channel_max, num_layers=num_layers,
                           num_critical=num_critical, first_cutoff=first_cutoff,
                           first_stopband=first_stopband, last_stopband_rel=last_stopband_rel,
                           margin_size=margin_size, num_fp16_res=num_fp16_res,
                           img_channels=img_channels, conv_kernel=conv_kernel,
                           filter_size=filter_size, lrelu_upsampling=lrelu_upsampling)
        self.schedule = s
        self.num_ws = num_layers + 2
        self.output_scale = float(output_scale)
        rates, cut, half = s["sampling_rates"], s["cutoffs"], s["half_widths"]
        self.input = SynthesisInput(w_dim=w_dim, channels=s["channels"][0], size=s["sizes"][0],
                                    sampling_rate=rates[0], bandwidth=cut[0],
                                    generator=component_rng(seed, NET_SG3, 0))
        self.layer_names: List[str] = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            tmp_rate = s["tmp_rates"][idx]
            layer = SynthesisLayer(
                w_dim=w_dim, torgb=idx == num_layers, reduced=s["reduced"][idx],
                in_channels=s["channels"][prev], out_channels=s["channels"][idx],
                up=s["up"][idx], down=s["down"][idx],
                up_filter=design_lowpass_filter(s["up_taps"][idx], cut[prev], half[prev] * 2,
                                                tmp_rate),
                down_filter=design_lowpass_filter(s["down_taps"][idx], cut[idx], half[idx] * 2,
                                                  tmp_rate),
                padding=s["padding"][idx], conv_kernel=conv_kernel, conv_clamp=conv_clamp,
                generator=component_rng(seed, NET_SG3, 1, idx))
            name = f"L{idx}_{s['sizes'][idx]}_{s['channels'][idx]}"
            setattr(self, name, layer)
            self.layer_names.append(name)

    def forward(self, ws: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """ws [B, num_ws, w_dim] → images [B, C, H, W] f32, channels_last."""
        per_layer = ws.float().unbind(dim=1)
        with float32_without_tf32():
            x = self.input(per_layer[0])
            for name, w in zip(self.layer_names, per_layer[1:]):
                x = getattr(self, name)(x, w, dtype)
            return x.float() * self.output_scale


class StyleGAN3Generator(nn.Module):
    """Mapping and synthesis; `forward(z, psi)` → [B, H, W, C] f32. The
    defaults are `stylegan3-t` at 1024²."""

    def __init__(self, *, z_dim: int = 512, w_dim: int = 512, mapping_layers: int = 2,
                 mapping_lr_multiplier: float = 0.01, resolution: int = 1024,
                 channel_base: int = 32768, channel_max: int = 512, num_layers: int = 14,
                 num_critical: int = 2, first_cutoff: float = 2.0,
                 first_stopband: float = 2 ** 2.1, last_stopband_rel: float = 2 ** 0.3,
                 margin_size: int = 10, output_scale: float = 0.25, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0, conv_kernel: int = 3, filter_size: int = 6,
                 lrelu_upsampling: int = 2, img_channels: int = 3, seed: int = 0):
        super().__init__()
        self.z_dim = int(z_dim)
        self.resolution = int(resolution)
        self.mapping = MappingNetwork(z_dim=z_dim, w_dim=w_dim, num_layers=mapping_layers,
                                      lr_mul=mapping_lr_multiplier, seed=seed)
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, resolution=resolution, img_channels=img_channels,
            channel_base=channel_base, channel_max=channel_max, num_layers=num_layers,
            num_critical=num_critical, first_cutoff=first_cutoff, first_stopband=first_stopband,
            last_stopband_rel=last_stopband_rel, margin_size=margin_size,
            output_scale=output_scale, num_fp16_res=num_fp16_res,
            conv_clamp=None if conv_clamp is None else float(conv_clamp),
            conv_kernel=conv_kernel, filter_size=filter_size,
            lrelu_upsampling=lrelu_upsampling, seed=seed)

    def forward(self, z: torch.Tensor, psi: float = 1.0, *,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """`compute_dtype` is the precision of the layers at the highest
        sampling rates; float32 computes the whole network in float32."""
        w = self.mapping(z, psi)
        ws = w.unsqueeze(1).expand(-1, self.synthesis.num_ws, -1)
        return self.synthesis(ws, compute_dtype).permute(0, 2, 3, 1)
