"""GAN losses of the train step — the counterpart of
`pggan_tpu/losses/gan.py:29-103`: BCE with logits, the R1 penalty, the
WGAN-GP penalty (a sum over the batch, as the reference), drift, and the G
loss. Every loss is a 0-d f32 tensor. The penalties differentiate D with
`torch.autograd.grad(create_graph=True)`, so the loss they enter can be
differentiated again with respect to D's weights. The rest of the loss zoo
(`losses/gan.py:113-166`) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def bce_with_logits(logits: torch.Tensor, target: int) -> torch.Tensor:
    """Mean binary cross-entropy against a constant target, in the stable
    form max(x, 0) − x·t + log1p(exp(−|x|))."""
    if target not in (0, 1):
        raise ValueError(f"target must be 0 or 1, got {target!r}")
    x = logits.float()
    loss = torch.clamp(x, min=0.0) - x * float(target) + torch.log1p(torch.exp(-x.abs()))
    return loss.mean()


def _input_grad(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    (grad,) = torch.autograd.grad(f, x, create_graph=True)
    return grad.float()


def r1_penalty_with_logits(d_fn: Callable[[torch.Tensor], torch.Tensor],
                           x_real: torch.Tensor, *, target: str = "logits"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D(x_real), the R1 penalty) from one D forward, as the train step
    needs both (`step.py:299-314`)."""
    if target not in ("logits", "loss"):
        raise ValueError(f"unknown r1 target {target!r}")
    x = x_real.detach().requires_grad_(True)
    pred = d_fn(x)
    f = pred.float().sum() if target == "logits" else bce_with_logits(pred, 1)
    grad = _input_grad(f, x)
    return pred, 0.5 * grad.square().reshape(grad.shape[0], -1).sum(dim=1).mean()


def r1_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor], x_real: torch.Tensor,
               *, target: str = "logits") -> torch.Tensor:
    """0.5 · E_b[Σ (∇ₓ f(x))²] on reals: f = Σ D(x) ('logits', the
    published R1) or BCE(D(x), 1) ('loss', the reference's call site)."""
    return r1_penalty_with_logits(d_fn, x_real, target=target)[1]


def gradient_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor],
                     x_real: torch.Tensor, x_fake: torch.Tensor,
                     eps: torch.Tensor, w_gp: float) -> torch.Tensor:
    """Σ_b (‖∇ D(eps·real + (1−eps)·fake)‖₂ − 1)² · W_gp, one eps per sample;
    a sum over the batch, not a mean (`pggan/loss.py:54-92`)."""
    b = x_real.shape[0]
    e = eps.reshape((b,) + (1,) * (x_real.ndim - 1)).to(x_real.dtype)
    interp = (e * x_real + (1.0 - e) * x_fake).detach().requires_grad_(True)
    grad = _input_grad(d_fn(interp)[:, 0].float().sum(), interp)
    norms = torch.sqrt(grad.square().reshape(b, -1).sum(dim=1))
    return (norms - 1.0).square().sum() * w_gp


def drift_loss(pred_real: torch.Tensor, w_drift: float) -> torch.Tensor:
    """Σ pred_real² · W_drift (`pggan/loss.py:94-100`, trained)."""
    return pred_real.float().square().sum() * w_drift


def generator_loss(pred_fake: torch.Tensor, w_adv: float) -> torch.Tensor:
    """W_adv · BCE(D(G(z)), 1)."""
    return w_adv * bce_with_logits(pred_fake, 1)
