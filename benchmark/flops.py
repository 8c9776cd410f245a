"""Model FLOPs of the progressive GAN: G's forward, D's forward and one D+G
train step, a copy of the repository's `step_model_tflops` arithmetic with
its stated convention.

Dense MACs × 2 of the reference formulation: a structural fusion that runs
fewer MACs (the dilated upscale-conv) still counts at the dense rate, so
the share of the peak compares across changes. Pass multipliers: one D or G
forward = 1, an input-gradient-only backward = 1, a parameter backward = 2.
  G: z₁ forward + z₂ forward + parameter backward (2) ............ = 4
  D, r1: real forward 1 + inner ∇ₓ 1 + outer reverse over [fwd, ∇ₓ]
         2×2 = 4 + fake forward 1 + fake parameter backward 2
         + G-phase forward 1 + G-phase input backward 1 ........ = 11
  D, wgangp: 2B forward 2 + their parameter backward 4 + interpolate
         forward 1 + inner ∇ₓ 1 + outer reverse 4 + G phase 2 ... = 14
  D, lazy R1 every k steps: (11 + (k−1)·8)/k, the plain steps dropping
         the inner ∇ₓ and the outer reverse (5) and paying the real
         parameter backward (2); what runs is what counts.
"""

from __future__ import annotations

from typing import Sequence


def _conv(batch: int, res: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * batch * res * res * k * k * cin * cout


def g_forward_flops(depths: Sequence[int], scale: int, batch: int,
                    latent_dim: int = 512) -> float:
    """FLOPs of one G forward of `batch` latents at `scale` (both toRGB
    heads at scale ≥ 1)."""
    d = list(depths)
    g = 2.0 * batch * latent_dim * 16 * d[0] + _conv(batch, 4, 3, d[0], d[0])
    for i in range(1, scale + 1):
        res = 2 ** (i + 2)
        g += _conv(batch, res, 3, d[i - 1], d[i]) + _conv(batch, res, 3, d[i], d[i])
    r = 2 ** (scale + 2)
    g += _conv(batch, r, 1, d[scale], 3)
    if scale >= 1:
        g += _conv(batch, r // 2, 1, d[scale - 1], 3)
    return g


def d_forward_flops(depths: Sequence[int], scale: int, batch: int) -> float:
    d = list(depths)
    r = 2 ** (scale + 2)
    dd = _conv(batch, r, 1, 3, d[scale])
    if scale >= 1:
        dd += _conv(batch, r // 2, 1, 3, d[scale - 1])
    for i in range(scale, 0, -1):
        res = 2 ** (i + 2)
        dd += _conv(batch, res, 3, d[i], d[i]) + _conv(batch, res, 3, d[i], d[i - 1])
    return dd + _conv(batch, 4, 3, d[0] + 1, d[0]) + 2.0 * batch * (16 * d[0] * d[0] + d[0])


def d_passes(loss_mode: str = "r1", r1_interval: int = 1) -> float:
    if loss_mode == "wgangp":
        return 14.0
    if r1_interval > 1:
        return (11.0 + (r1_interval - 1) * 8.0) / r1_interval
    return 11.0


def step_model_tflops(depths: Sequence[int], scale: int, batch: int, latent_dim: int = 512,
                      loss_mode: str = "r1", r1_interval: int = 1) -> float:
    """TFLOP of one D+G train step, averaged over a lazy-R1 window."""
    return (4.0 * g_forward_flops(depths, scale, batch, latent_dim)
            + d_passes(loss_mode, r1_interval) * d_forward_flops(depths, scale, batch)) / 1e12
