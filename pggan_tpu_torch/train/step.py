"""The PGGAN train step, eager — the counterpart of `make_train_step`
(`pggan_tpu/train/step.py:151-413`):

  1. real fade-in at scale > 0: uint8 → /127.5 − 1, 2× average pool,
     nearest 2× upscale, (1-α)·low + α·real (`step.py:258-277`);
  2. D phase (`:279-369`): fake = G(z₁) under no_grad; loss_r1 =
     BCE(D(real), 1) + BCE(D(fake), 0) + R1, the R1 penalty from a separate
     real forward and `autograd.grad(create_graph=True)`, scaled
     0.5·mean·r1_scale and by no W_gp (`:314`); without R1 (and for
     wgangp) real and fake go through one 2B forward when B % 4 == 0;
     Adam on D;
  3. G phase (`:371-383`) against the *updated* D: loss_G = W_adv ·
     BCE(D(G(z₂)), 1); the gradient goes to G's weights only; Adam on G;
  4. the optional G weight average after the G update (`:387-390`).

A step mutates the state in place: the modules' weights, the optimizers'
moments and the random generator. z₁, z₂ and the WGAN-GP eps may be passed
in (a test feeds the values JAX drew); otherwise they are drawn from the
state's `torch.Generator` on the step's device. The JAX package's runtime
`lax.cond` for lazy R1 and its `lax.scan` chunking are not ported: the
trainer runs a lazy-R1 window as one `include_r1=True` step followed by
`include_r1=False` steps.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from pggan_tpu_torch.losses.gan import (bce_with_logits, drift_loss,
                                        generator_loss, gradient_penalty,
                                        r1_penalty_with_logits)
from pggan_tpu_torch.models.discriminator import Discriminator
from pggan_tpu_torch.models.generator import Generator
from pggan_tpu_torch.ops.basic import blend, downscale2d, upscale2d

Metrics = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    G: Generator
    D: Discriminator
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam
    rng: torch.Generator
    # the smoothed generator (PGGAN paper §A.1); None when g_ema_decay is 0
    G_ema: Optional[Generator] = None


def make_optimizers(cfg, G: Generator, D: Discriminator
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """Fresh Adam for each network (`step.py:58-66`). torch's Adam places
    eps as optax's does: lr·m̂ / (sqrt(v̂) + eps)."""
    betas = (float(cfg.beta1), float(cfg.beta2))
    return (torch.optim.Adam(G.parameters(), lr=float(cfg.lr_G), betas=betas,
                             eps=float(cfg.adam_eps)),
            torch.optim.Adam(D.parameters(), lr=float(cfg.lr_D), betas=betas,
                             eps=float(cfg.adam_eps)))


def init_train_state(cfg, G: Generator, D: Discriminator, rng: torch.Generator,
                     G_ema: Optional[Generator] = None) -> TrainState:
    """A state with fresh optimizers. With g_ema_decay > 0 and no average
    given, the average starts as a copy of G."""
    opt_G, opt_D = make_optimizers(cfg, G, D)
    if G_ema is None and float(cfg.g_ema_decay) > 0.0:
        G_ema = copy.deepcopy(G).requires_grad_(False)
    return TrainState(G, D, opt_G, opt_D, rng, G_ema)


def normalize_images(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] → f32 [-1, 1]; float images pass as f32."""
    if img.dtype == torch.uint8:
        return img.float() / 127.5 - 1.0
    return img.float()


def make_train_step(cfg, scale_index: int, *, include_r1: Optional[bool] = None,
                    r1_scale: Optional[float] = None) -> Callable:
    """Build the step for one progressive scale. Returns
    step(state, img_real, alpha, *, z1=None, z2=None, eps=None) → metrics,
    a dict of 0-d tensors (L_D, L_D_real, L_D_fake, L_D_r1 or L_D_gp and
    L_D_eps, L_G).

    `include_r1` (loss_mode 'r1'): None or True applies the penalty, False
    leaves it out (the tail of a lazy window). `r1_scale` multiplies the
    penalty; None → r1_interval, the JAX package's default for its static
    programs (`step.py:208-214`)."""
    latent_dim = int(cfg.latent_dim)
    w_adv, w_gp, w_drift = float(cfg.W_adv), float(cfg.W_gp), float(cfg.W_drift_D)
    loss_mode = str(cfg.loss_mode)
    if loss_mode not in ("r1", "wgangp"):
        raise ValueError(f"unknown loss mode {loss_mode!r}")
    r1_target = str(cfg.r1_target)
    with_r1 = include_r1 is None or bool(include_r1)
    r1_mult = float(r1_scale) if r1_scale is not None else float(cfg.r1_interval)
    apply_mbn = bool(cfg.apply_minibatch_norm)
    ema_decay = float(cfg.g_ema_decay)
    dt = torch.bfloat16 if str(cfg.compute_dtype) == "bfloat16" else torch.float32

    def step(state: TrainState, img_real: torch.Tensor, alpha: float, *,
             z1: Optional[torch.Tensor] = None, z2: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None) -> Metrics:
        G, D = state.G, state.D
        device = next(G.parameters()).device
        batch = img_real.shape[0]

        def draw(shape, fn, given):
            if given is not None:
                return given.to(device=device, dtype=torch.float32)
            return fn(shape, generator=state.rng, device=device)
        z1 = draw((batch, latent_dim), torch.randn, z1)
        z2 = draw((batch, latent_dim), torch.randn, z2)
        eps = draw((batch,), torch.rand, eps)

        # ---- real fade-in (NHWC in and out; the ops see channels_last) ----
        real = normalize_images(img_real.to(device)).permute(0, 3, 1, 2)
        if scale_index > 0:
            real = blend(upscale2d(downscale2d(real)), real, alpha)
        real = real.permute(0, 2, 3, 1)

        def d_fn(images):
            return D(images, alpha, compute_dtype=dt)

        # ---- D phase ----
        with torch.no_grad():
            fake = G(z1, alpha, compute_dtype=dt)
        fuse = batch % 4 == 0 or not apply_mbn
        metrics: Metrics = {}
        if loss_mode == "r1" and with_r1:
            pred_real, reg = r1_penalty_with_logits(d_fn, real, target=r1_target)
            reg = reg * r1_mult
            pred_fake = d_fn(fake)
        elif fuse:
            pred = d_fn(torch.cat([real, fake]))
            pred_real, pred_fake = pred[:batch], pred[batch:]
        else:
            pred_real, pred_fake = d_fn(real), d_fn(fake)
        l_real = bce_with_logits(pred_real, 1)
        l_fake = bce_with_logits(pred_fake, 0)
        if loss_mode == "r1":
            if not with_r1:
                reg = torch.zeros((), device=device)
            loss_d = l_real + l_fake + reg
            metrics.update(L_D_real=l_real, L_D_fake=l_fake, L_D_r1=reg, L_D=loss_d)
        else:
            gp = (gradient_penalty(d_fn, real, fake, eps, w_gp) if w_gp
                  else torch.zeros((), device=device))
            drift = (drift_loss(pred_real, w_drift) if w_drift
                     else torch.zeros((), device=device))
            loss_d = l_real + l_fake + gp + drift
            metrics.update(L_D_real=l_real, L_D_fake=l_fake, L_D_gp=gp,
                           L_D_eps=drift, L_D=loss_d)
        state.opt_D.zero_grad(set_to_none=True)
        loss_d.backward(inputs=list(D.parameters()))
        state.opt_D.step()

        # ---- G phase, against the updated D; D collects no gradient ----
        fake2 = G(z2, alpha, compute_dtype=dt)
        loss_g = generator_loss(d_fn(fake2), w_adv)
        state.opt_G.zero_grad(set_to_none=True)
        loss_g.backward(inputs=list(G.parameters()))
        state.opt_G.step()
        metrics["L_G"] = loss_g

        if ema_decay > 0.0 and state.G_ema is not None:
            with torch.no_grad():
                for e, p in zip(state.G_ema.state_dict().values(),
                                G.state_dict().values()):
                    e.mul_(ema_decay).add_(p.to(e.dtype), alpha=1.0 - ema_decay)
        return {k: v.detach() for k, v in metrics.items()}

    return step
