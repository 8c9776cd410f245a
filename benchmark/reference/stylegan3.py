"""The plain reference of StyleGAN3-T's generator (Karras et al. 2021,
"Alias-Free Generative Adversarial Networks", arXiv:2106.12423), in float32
torch ops with no kernel, cache or fusion, following NVIDIA's PyTorch code
(github.com/NVlabs/stylegan3, `training/networks_stylegan3.py`:
`MappingNetwork`, `SynthesisInput`, `SynthesisLayer`, `SynthesisNetwork`;
`torch_utils/ops/filtered_lrelu.py`'s reference path) and its parameter
names.

    z [B, z_dim] → z·rsqrt(mean(z²) + 1e-8) → `mapping_layers` × (FC, lr
    multiplier 0.01, bias + lrelu·√2) → w, broadcast to num_layers + 2 ws
    (ψ lerps w towards `mapping.w_avg`) →
    the input layer: Fourier features whose frequencies and phases affine
    (ws[0]) rotates and translates, sin(2π(grid·freqs + phases))·amplitudes
    on a sizes[0]² grid, then a channel mix →
    layers L0 … L{num_layers − 1}: styles = affine(w); each sample's
    weights pre-normalised (w by its RMS per output channel, s by its RMS),
    modulated, demodulated and multiplied by the input gain
    rsqrt(magnitude_ema); a 3×3 conv with padding 2; + bias; the filtered
    leaky ReLU: zero insertion ×up, the layer's pads, the up filter (gain up
    on each axis), lrelu(0.2)·√2, clamp ±conv_clamp, the down filter and
    decimation ×down →
    L{num_layers} (toRGB): styles × 1/√C_in × the input gain, a 1×1 conv
    without demodulation, + bias, clamp → × output_scale → [B, H, W, C].

The schedule (cutoffs, stopbands, sampling rates, sizes, channels, factors,
taps and pads) and the filters (scipy's `firwin` with a Kaiser window, as
NVIDIA's `design_lowpass_filter` calls it) are computed here in float64
torch, apart from the program's.

Departures from NVIDIA's code, none of which changes the function:
- the batch is computed one image at a time (layer 10's float32
  intermediate is 1.4 GB an image), and each image's modulated convolution
  explicitly, one conv2d with its own weights s·w·d·gain, not NVIDIA's
  grouped convolution; so the styles' pre-normalisation divides by the RMS
  of one image's styles, not of the batch's, which the demodulation cancels
  up to its 1e-8 against Σ(w·s)² ≈ 9·C_in;
- each FIR stage is zero insertion, the pads (negative ones crop), and the
  1-D filter applied along the rows and then along the columns, each a
  one-channel float32 `conv1d` over all the lines (strided to decimate);
  NVIDIA's reference path runs the two 1-D passes as depthwise 2-D
  convolutions. (On an H100 the conv1d form ran the whole reference at
  0.13 s an image against 0.31 s for sums of shifted slices.)
- sampling only: no magnitude_ema update, no truncation cutoff, no class
  label, no `w_avg` tracking; the input layer's `transform` is the
  identity, as NVIDIA initialises it.

`quant_f32` and `quant_low`, when given, round every conv or linear input
and weight on the way in: the first where the program computes in float32
(the mapping, the input layer's channel mix, the affines, the layers below
the reduced-precision ones), the second in the layers whose sampling rate ×
2^num_fp16_res exceeds the resolution. They serve the benchmark's
lower-precision control. TF32 is off while the reference runs.

This file imports nothing but torch. It is the oracle of the benchmark's
check and of the CPU tests (`tests/test_torch_stylegan3.py`), so both hold
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

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return x if quant is None else quant(x)


def schedule(cfg: dict) -> List[dict]:
    """One dict a layer, 0 … num_layers (the last the toRGB): `name`
    (NVIDIA's L{idx}_{size}_{channels}), `in_channels`, `channels`,
    `in_size`, `size`, `rate`, `tmp_rate`, `cutoff` and `half_width` of its
    input (`in_*`) and output, `up`, `down`, `up_taps`, `down_taps`,
    `padding` (x0, x1, y0, y1), `reduced`, `torgb`."""
    res, n = int(cfg["resolution"]), int(cfg["num_layers"])
    critical = int(cfg["num_critical"])
    first_cut, first_stop = float(cfg["first_cutoff"]), float(cfg["first_stopband"])
    last_cut = res / 2
    last_stop = last_cut * float(cfg["last_stopband_rel"])
    cut, stop, rate, half, size, chans = [], [], [], [], [], []
    for idx in range(n + 1):
        e = min(idx / (n - critical), 1.0)
        cut.append(first_cut * (last_cut / first_cut) ** e)
        stop.append(first_stop * (last_stop / first_stop) ** e)
        rate.append(2.0 ** math.ceil(math.log2(min(stop[-1] * 2, res))))
        half.append(max(stop[-1], rate[-1] / 2) - cut[-1])
        size.append(int(rate[-1]) + 2 * int(cfg["margin_size"]))
        chans.append(int(round(min(float(cfg["channel_base"]) / 2 / cut[-1],
                                   float(cfg["channel_max"])))))
    size[-2:] = [res, res]
    chans[-1] = int(cfg["img_channels"])
    layers = []
    for idx in range(n + 1):
        prev = max(idx - 1, 0)
        torgb = idx == n
        kernel = 1 if torgb else int(cfg["conv_kernel"])
        tmp = max(rate[prev], rate[idx]) * (1 if torgb else int(cfg["lrelu_upsampling"]))
        up, down = int(round(tmp / rate[prev])), int(round(tmp / rate[idx]))
        fsize = int(cfg["filter_size"])
        up_taps = fsize * up if up > 1 and not torgb else 1
        down_taps = fsize * down if down > 1 and not torgb else 1
        total = (size[idx] - 1) * down + 1 - (size[prev] + kernel - 1) * up
        total += up_taps + down_taps - 2
        lo = (total + up) // 2
        layers.append(dict(
            name=f"L{idx}_{size[idx]}_{chans[idx]}", in_channels=chans[prev],
            channels=chans[idx], in_size=size[prev], size=size[idx], rate=rate[idx],
            tmp_rate=tmp, in_cutoff=cut[prev], cutoff=cut[idx], in_half_width=half[prev],
            half_width=half[idx], up=up, down=down, up_taps=up_taps, down_taps=down_taps,
            kernel=kernel, padding=(lo, total - lo, lo, total - lo),
            reduced=rate[idx] * 2 ** int(cfg["num_fp16_res"]) > res, torgb=torgb))
    return layers


def input_spec(cfg: dict) -> dict:
    """The input layer's channels, size, sampling rate and bandwidth: layer
    0's output's."""
    first = schedule(cfg)[0]
    return dict(channels=first["in_channels"], size=first["in_size"], rate=first["rate"],
                bandwidth=first["in_cutoff"])


def lowpass(numtaps: int, cutoff: float, width: float, fs: float) -> Optional[torch.Tensor]:
    """scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs): a windowed
    sinc with a Kaiser window of scipy's beta for the transition width,
    scaled to sum 1, float32; None for one tap."""
    if numtaps == 1:
        return None
    nyq = fs / 2
    atten = 2.285 * (numtaps - 1) * math.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    m = torch.arange(numtaps, dtype=torch.float64) - (numtaps - 1) / 2
    c = cutoff / nyq
    h = c * torch.sinc(c * m) * torch.kaiser_window(numtaps, periodic=False, beta=beta,
                                                    dtype=torch.float64)
    return (h / h.sum()).float()


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter and persistent buffer, NVIDIA's names."""
    z, w = int(cfg["z_dim"]), int(cfg["w_dim"])
    out: List[Tuple[str, Tuple[int, ...]]] = [("mapping.w_avg", (w,))]
    for i in range(int(cfg["mapping_layers"])):
        out += [(f"mapping.fc{i}.weight", (w, z if i == 0 else w)), (f"mapping.fc{i}.bias", (w,))]
    c0 = input_spec(cfg)["channels"]
    out += [("synthesis.input.weight", (c0, c0)), ("synthesis.input.affine.weight", (4, w)),
            ("synthesis.input.affine.bias", (4,)), ("synthesis.input.transform", (3, 3)),
            ("synthesis.input.freqs", (c0, 2)), ("synthesis.input.phases", (c0,))]
    for layer in schedule(cfg):
        name, cin, k = "synthesis." + layer["name"], layer["in_channels"], layer["kernel"]
        out += [(f"{name}.affine.weight", (cin, w)), (f"{name}.affine.bias", (cin,)),
                (f"{name}.weight", (layer["channels"], cin, k, k)),
                (f"{name}.bias", (layer["channels"],)), (f"{name}.magnitude_ema", ())]
    return out


def lrelu(x: torch.Tensor, slope: float = SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


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


def synthesis_input(p: Params, w: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """w [B, w_dim] → [B, C, size, size]: NVIDIA's `SynthesisInput.forward`."""
    spec = input_spec(cfg)
    batch, size, rate, band = w.shape[0], spec["size"], spec["rate"], spec["bandwidth"]
    t = fully_connected(p, "synthesis.input.affine", w, quant=quant)     # (r_c, r_s, t_x, t_y)
    t = t / t[:, :2].norm(dim=1, keepdim=True)
    m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat([batch, 1, 1])
    m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
    m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat([batch, 1, 1])
    m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
    transforms = m_r @ m_t @ p["synthesis.input.transform"].unsqueeze(0)
    freqs = p["synthesis.input.freqs"].unsqueeze(0)
    phases = p["synthesis.input.phases"].unsqueeze(0) + (freqs @ transforms[:, :2, 2:]).squeeze(2)
    freqs = freqs @ transforms[:, :2, :2]
    amplitudes = (1 - (freqs.norm(dim=2) - band) / (rate / 2 - band)).clamp(0, 1)
    theta = torch.eye(2, 3, device=w.device)
    theta[0, 0] = theta[1, 1] = 0.5 * size / rate
    grids = F.affine_grid(theta.unsqueeze(0), [1, 1, size, size], align_corners=False)
    x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
    x = torch.sin((x + phases.unsqueeze(1).unsqueeze(2)) * (2 * math.pi))
    x = x * amplitudes.unsqueeze(1).unsqueeze(2)
    weight = p["synthesis.input.weight"]
    x = _q(x, quant) @ _q(weight / math.sqrt(weight.shape[0]), quant).t()
    return x.permute(0, 3, 1, 2)


def fir(x: torch.Tensor, f: Optional[torch.Tensor], up: int, down: int, pads: Tuple[int, int],
        gain: float, dim: int) -> torch.Tensor:
    """One axis (`dim`, -1 or -2) of upfirdn2d: up − 1 zeros after each
    sample, `pads` (before, after; negative crops), the filter f × gain as a
    convolution (a one-channel `conv1d`, which correlates, with f flipped)
    over every line along the axis, and every `down`-th output (its
    stride)."""
    if dim == -2:
        return fir(x.transpose(-1, -2), f, up, down, pads, gain, -1).transpose(-1, -2)
    if up > 1:
        x = F.pad(x.unsqueeze(-1), [0, up - 1]).flatten(-2)
    x = F.pad(x, list(pads))
    taps = torch.ones(1) if f is None else f.flip(0)
    weight = (taps * gain).to(device=x.device, dtype=x.dtype).view(1, 1, -1)
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), weight, stride=down)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def filtered_lrelu(x: torch.Tensor, layer: dict, fu: Optional[torch.Tensor],
                   fd: Optional[torch.Tensor], bias: torch.Tensor, clamp: float) -> torch.Tensor:
    """+ bias, the up stage (gain up on each axis), lrelu·√2 (slope 1 and
    gain 1 for the toRGB), clamp, the down stage."""
    x = x + bias.view(1, -1, 1, 1)
    up, down = layer["up"], layer["down"]
    x0, x1, y0, y1 = layer["padding"]
    if fu is not None or up > 1 or any(layer["padding"]):
        x = fir(x, fu, up, 1, (x0, x1), float(up), -1)
        x = fir(x, fu, up, 1, (y0, y1), float(up), -2)
    x = x if layer["torgb"] else lrelu(x) * SQRT2
    x = x.clamp(-clamp, clamp)
    if fd is not None or down > 1:
        x = fir(x, fd, 1, down, (0, 0), 1.0, -1)
        x = fir(x, fd, 1, down, (0, 0), 1.0, -2)
    return x


def modulated_conv(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                   input_gain: torch.Tensor, *, demodulate: bool, padding: int,
                   quant: Quant = None) -> torch.Tensor:
    """One image x [1, I, H, W] convolved with its own weights: w and s
    pre-normalised (with demodulation), w·s, demodulated, × the input gain."""
    w, s = weight, styles[0]
    if demodulate:
        w = w * w.square().mean(dim=[1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w * s.view(1, -1, 1, 1)
    if demodulate:
        w = w * (w.square().sum(dim=[1, 2, 3], keepdim=True) + EPS).rsqrt()
    w = w * input_gain
    return F.conv2d(_q(x, quant), _q(w, quant), padding=padding)


def filters(cfg: dict) -> Dict[str, Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]:
    """{layer name: (up filter, down filter)}, f32 on the CPU."""
    out = {}
    for layer in schedule(cfg):
        out[layer["name"]] = (
            lowpass(layer["up_taps"], layer["in_cutoff"], layer["in_half_width"] * 2,
                    layer["tmp_rate"]),
            lowpass(layer["down_taps"], layer["cutoff"], layer["half_width"] * 2,
                    layer["tmp_rate"]))
    return out


def synthesis_layer(p: Params, x: torch.Tensor, w: torch.Tensor, layer: dict, fir_taps,
                    cfg: dict, quant_f32: Quant = None, quant_low: Quant = None) -> torch.Tensor:
    """One layer (`schedule`'s dict) on one image x with its w [1, w_dim]."""
    name = "synthesis." + layer["name"]
    styles = fully_connected(p, name + ".affine", w, quant=quant_f32)
    if layer["torgb"]:
        styles = styles / math.sqrt(layer["in_channels"] * layer["kernel"] ** 2)
    gain = p[name + ".magnitude_ema"].rsqrt()
    x = modulated_conv(x, p[name + ".weight"], styles, gain, demodulate=not layer["torgb"],
                       padding=layer["kernel"] - 1,
                       quant=quant_low if layer["reduced"] else quant_f32)
    fu, fd = fir_taps[layer["name"]]
    return filtered_lrelu(x, layer, fu, fd, p[name + ".bias"], float(cfg["conv_clamp"]))


def synthesis(p: Params, ws: torch.Tensor, cfg: dict, quant_f32: Quant = None,
              quant_low: Quant = None) -> torch.Tensor:
    """ws [B, num_ws, w_dim] → images [B, C, H, W], one image at a time."""
    layers, fir_taps = schedule(cfg), filters(cfg)
    images = []
    for b in range(ws.shape[0]):
        x = synthesis_input(p, ws[b:b + 1, 0], cfg, quant_f32)
        for idx, layer in enumerate(layers):
            x = synthesis_layer(p, x, ws[b:b + 1, idx + 1], layer, fir_taps, cfg, quant_f32,
                                quant_low)
        images.append(x * float(cfg["output_scale"]))
    return torch.cat(images)


def calibrate_magnitudes(p: Params, z: torch.Tensor, cfg: dict) -> None:
    """Each layer's `magnitude_ema`, in place, the mean square of its input
    for the one latent z [1, z_dim], layer by layer: NVIDIA's
    `update_emas` step with its decay at 0, one pass in place of training's
    moving average, so that every layer's input reaches it at unit RMS."""
    w = mapping(p, z, cfg)
    x = synthesis_input(p, w, cfg)
    fir_taps = filters(cfg)
    for layer in schedule(cfg):
        p["synthesis." + layer["name"] + ".magnitude_ema"] = x.square().mean()
        x = synthesis_layer(p, x, w, layer, fir_taps, cfg)


def generator(p: Params, z: torch.Tensor, cfg: dict, psi: float = 1.0,
              quant_f32: Quant = None, quant_low: Quant = None) -> torch.Tensor:
    """z [B, z_dim] → images [B, H, W, C]."""
    w = mapping(p, z, cfg, quant_f32)
    if psi != 1.0:
        w = p["mapping.w_avg"].lerp(w, psi)
    ws = w.unsqueeze(1).expand(-1, int(cfg["num_layers"]) + 2, -1)
    return synthesis(p, ws, cfg, quant_f32, quant_low).permute(0, 2, 3, 1)
