"""StyleGAN2's modulated convolution (Karras et al. 2020, arXiv:1912.04958,
§2.2, eq. 1-3): a convolution whose weights each sample scales by its own
style s and, with demodulation, renormalises to unit norm per output channel,

    w'_boik = s_bi · w_oik · d_bo,   d_bo = rsqrt(Σ_ik (s_bi · w_oik)² + eps).

It is computed in the unfused form of stylegan2-ada-pytorch's
`modulated_conv2d`: the activations are scaled before and after one
convolution with the shared weight,

    y = d ⊙ conv(x ⊙ s, w) + noise,

which equals the convolution with the per-sample weights w' exactly (the
grouped form, NVIDIA's `fused_modconv`, was timed against it at the 1024²
cell's shapes on an H100 and lost: PERF.md). d comes from one product,
Σ_i s_bi² Σ_k w_oik², in f32. With `up = 2` the input is first upsampled
through the FIR filter (`upsample2d`, padding as NVIDIA's `conv2d_resample`
takes it), then convolved without padding.

A caller may pass the layer's epilogue (`act`, `bias`, `clamp`: StyleGAN2's
`bias_act(lrelu, gain √2, clamp)`, or StyleGAN3's `linear`, x·d + b, before
its filtered leaky ReLU). With demodulation and a leaky ReLU or `linear`,
where autograd does not record the call and no program is being exported,
the demodulation, noise, bias, activation and clamp are one pass over the
conv's output, `kernels.modconv_epilogue` (the bias-act kernel on a CUDA
tensor; `linear` is its leaky ReLU of slope 1 and gain 1), with d, noise and
the bias in f32 and one rounding to x's dtype. Otherwise they are composed:
d and noise rounded to x's dtype, `torch.addcmul`, then `bias_act` with the
bias in x's dtype.

StyleGAN3 (Karras et al. 2021, arXiv:2106.12423; NVIDIA's
`networks_stylegan3.modulated_conv2d`) adds two options. `prenormalize`
scales each output channel's weights and the styles (over the whole batch)
to unit RMS before they meet, in f32; demodulation cancels both up to its
eps. `input_gain` (a scalar, StyleGAN3's rsqrt of the layer's input
magnitude) multiplies the styles after d is formed from them, so it scales
the output as NVIDIA's per-sample weights do.

x is a logical NCHW tensor in `torch.channels_last` memory, in the block's
compute dtype; weight ([O, I, kh, kw]) and styles ([B, I]) are f32 and are
cast to x's dtype where they meet it, as NVIDIA's code does. `counts`
tallies the calls (`modconv`) and those whose epilogue took the one pass
(`fused_epilogue`); each call is a `stylegan2.modconv` profiler range, its
epilogue included, and its upsample a `stylegan2.resample` range inside it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from pggan_tpu_torch.ops import kernels
from pggan_tpu_torch.ops.basic import bias_act
from pggan_tpu_torch.ops.resample import upsample2d

EPS = 1e-8
MODCONV_SPAN = "stylegan2.modconv"
RESAMPLE_SPAN = "stylegan2.resample"

# Modulated convolutions since the last `reset_counts()`, and those whose
# epilogue ran as one pass.
counts = {"modconv": 0, "fused_epilogue": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor, *,
                     demodulate: bool = True, up: int = 1, padding: int = 0,
                     resample_filter: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     flip_weight: bool = True, act: Optional[str] = None,
                     bias: Optional[torch.Tensor] = None,
                     clamp: Optional[float] = None, prenormalize: bool = False,
                     input_gain=None) -> torch.Tensor:
    """[B, I, H, W] → [B, O, H·up, W·up] (+ 2·padding − k + 1 a side for a
    k×k kernel). `flip_weight=False` convolves (NVIDIA's up = 2 layers),
    True correlates; `noise` ([H·up, W·up]) is added after the
    demodulation. With `act`, the layer's epilogue `bias_act(·, bias, act,
    clamp=clamp)` follows, as one pass where the module docstring says;
    `prenormalize` and `input_gain` are StyleGAN3's."""
    counts["modconv"] += 1
    with record_function(MODCONV_SPAN):
        batch, dt = x.shape[0], x.dtype
        if prenormalize:
            weight = weight.float()
            weight = weight * weight.square().mean(dim=[1, 2, 3], keepdim=True).rsqrt()
            styles = styles.float()
            styles = styles * styles.square().mean().rsqrt()
        scale = styles if input_gain is None else styles * input_gain
        x = x * scale.to(dt).reshape(batch, -1, 1, 1)
        w = weight.to(dt)
        if not flip_weight:
            w = w.flip([2, 3])
        if up > 1:
            with record_function(RESAMPLE_SPAN):
                x = upsample2d(x, resample_filter, up=up, padding=padding)
            padding = 0
        x = F.conv2d(x, w, padding=padding)
        if demodulate:
            # d [B, O] = rsqrt(Σ_i s_bi² Σ_k w_oik² + eps), one f32 product
            d = torch.rsqrt(styles.float().square() @ weight.float().square().sum(dim=[2, 3]).t()
                            + EPS)
            if act in ("lrelu", "linear") and not torch.compiler.is_exporting() and not (
                    torch.is_grad_enabled() and any(
                        t is not None and t.requires_grad
                        for t in (x, weight, styles, noise, bias))):
                counts["fused_epilogue"] += 1
                if act == "linear":
                    return kernels.modconv_epilogue(x, d, noise, bias, slope=1.0, gain=1.0,
                                                    clamp=clamp)
                return kernels.modconv_epilogue(x, d, noise, bias, clamp=clamp)
            d = d.to(dt).reshape(batch, -1, 1, 1)
            # x·d + noise in one pass, as NVIDIA's `fma`
            x = x * d if noise is None else torch.addcmul(noise.to(dt), x, d)
        elif noise is not None:
            x = x + noise.to(dt)
        if act is None:
            return x
        return bias_act(x, None if bias is None else bias.to(dt), act=act, clamp=clamp)
