"""GAN losses — the counterpart of `pggan_tpu/losses/gan.py`: the train
step's BCE with logits, R1 penalty, WGAN-GP penalty (a sum over the batch,
as the reference), drift and G loss, and the rest of the reference's loss
zoo (`lib/loss.py:54-141`): the softplus and hinge GAN losses and the
identity, L1, L2, same-person and attribute losses its face-swap trainers
use. Every loss is a 0-d f32 tensor. The penalties differentiate D with
`torch.autograd.grad(create_graph=True)`, so the loss they enter can be
differentiated again with respect to D's weights.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, target: int) -> torch.Tensor:
    """Mean binary cross-entropy against a constant target, in the stable
    form max(x, 0) − x·t + log1p(exp(−|x|))."""
    if target not in (0, 1):
        raise ValueError(f"target must be 0 or 1, got {target!r}")
    x = logits.float()
    loss = torch.clamp(x, min=0.0) - x * float(target) + torch.log1p(torch.exp(-x.abs()))
    return loss.mean()


def softplus_loss(logit: torch.Tensor, is_real: bool = True) -> torch.Tensor:
    """Non-saturating softplus GAN loss, mean softplus(∓x) (`lib/loss.py:95-99`)."""
    x = logit.float()
    return F.softplus(-x if is_real else x).mean()


def hinge_loss(logit: torch.Tensor, positive: bool = True) -> torch.Tensor:
    """Hinge GAN loss, mean relu(1 − x) or relu(1 + x) (`lib/loss.py:108-112`)."""
    x = logit.float()
    return F.relu(1.0 - x if positive else x + 1.0).mean()


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


# ---- the reconstruction, identity and attribute losses of the reference's
# face-swap trainers (`lib/loss.py:62-91`), in f32 ----

def id_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """mean(1 − cos(a, b)) over [B, D] embeddings, each norm clamped at eps
    as `F.cosine_similarity` does (`lib/loss.py:62-63`)."""
    a, b = a.float(), b.float()
    na = torch.linalg.vector_norm(a, dim=1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=1).clamp_min(eps)
    return (1.0 - (a * b).sum(dim=1) / (na * nb)).mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (`lib/loss.py:71-73`)."""
    return (a.float() - b.float()).abs().mean()


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error (`lib/loss.py:75-77`)."""
    return (a.float() - b.float()).square().mean()


def _same_person(per_sample: torch.Tensor, same_person: torch.Tensor,
                 batch: int) -> torch.Tensor:
    mask = same_person.float().reshape(batch)
    return (per_sample * mask).sum() / (mask.sum() + 1e-6)


def l1_loss_with_same_person(a: torch.Tensor, b: torch.Tensor, same_person: torch.Tensor,
                             batch_per_gpu: int) -> torch.Tensor:
    """Σ_b mean|a_b − b_b| · same_b / (Σ same + 1e-6) (`lib/loss.py:79-80`)."""
    per = (a.float() - b.float()).abs().reshape(batch_per_gpu, -1).mean(dim=1)
    return _same_person(per, same_person, batch_per_gpu)


def l2_loss_with_same_person(a: torch.Tensor, b: torch.Tensor, same_person: torch.Tensor,
                             batch_per_gpu: int) -> torch.Tensor:
    """Σ_b 0.5·mean(a_b − b_b)² · same_b / (Σ same + 1e-6) (`lib/loss.py:82-83`)."""
    per = 0.5 * (a.float() - b.float()).square().reshape(batch_per_gpu, -1).mean(dim=1)
    return _same_person(per, same_person, batch_per_gpu)


def attr_loss(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
              batch_size: int) -> torch.Tensor:
    """Σ_levels Σ_b mean(aᵢ_b − bᵢ_b)², halved (`lib/loss.py:85-91`; the
    reference sums over the batch at each level)."""
    total = torch.zeros((), dtype=torch.float32)   # a 0-d CPU tensor joins any device
    for ai, bi in zip(a, b):
        d = (ai.float() - bi.float()).square().reshape(batch_size, -1)
        total = total + d.mean(dim=1).sum()
    return total / 2.0
