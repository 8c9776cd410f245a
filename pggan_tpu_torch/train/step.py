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
state's `torch.Generator` on the step's device.

Data parallel (`parallel/mesh.py`): with `world_size` W > 1 each rank runs
the step on its rows of the global batch. It draws the global z₁, z₂ and
eps (W·B rows) from the generator every rank holds in the same state, and
keeps rows [rank·B, (rank+1)·B), as the JAX mesh draws with one replicated
key and shards the draw; so the generators stay equal across ranks.
`grad_sync` (e.g. `mesh.all_reduce_mean_`) averages each network's
gradients between `backward` and the optimizer step, so every rank applies
the gradient of the global batch. The WGAN-GP penalty and drift are sums
over the batch, so a rank weighs its own sum by W before the average. The
step's metrics stay the rank's own; the trainer averages them on
loss_cycle steps. The JAX package's runtime
`lax.cond` for lazy R1 is not ported: the trainer runs a lazy-R1 window as
one `include_r1=True` step followed by `include_r1=False` steps. Its
`lax.scan` chunking (`make_chunked_train_step`) is `train/graphs.py`: the
step captured in a CUDA graph and replayed once a step of the window. So
the step reads no device value on the host, and takes `alpha` and
`r1_scale` as floats or as 0-d f32 tensors on its device, read when it runs
(the same bits either way); `resolve_steps_per_dispatch` is JAX's window
length rule.

`eval_losses` is the held-out evaluation forward of the trainer's
`validation` (`pggan_tpu/train/trainer.py:598-625`): the same real fade, no
update and no regularizer.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

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
    eps as optax's does: lr·m̂ / (sqrt(v̂) + eps). On a card it is
    `capturable` (its step count and bias correction on the device), so a
    CUDA graph can capture its step (`train/graphs.py`); eager steps there
    use the same settings, so both give the same bits. On the CPU it keeps
    the count on the host."""
    betas = (float(cfg.beta1), float(cfg.beta2))
    capturable = next(G.parameters()).is_cuda
    return tuple(torch.optim.Adam(net.parameters(), lr=float(lr), betas=betas,
                                  eps=float(cfg.adam_eps), capturable=capturable)
                 for net, lr in ((G, cfg.lr_G), (D, cfg.lr_D)))


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


def resolve_steps_per_dispatch(cfg, scale_index: int) -> int:
    """The window length of `steps_per_dispatch` (`step.py:509-523`): 1
    runs every step alone; 'auto' is 8 at resolutions up to 128², else 1
    (JAX's rule, kept as it is; PERF.md has the card's rates); below 1
    raises."""
    v = cfg["steps_per_dispatch"] if "steps_per_dispatch" in cfg else 1
    if v == "auto":
        res = 2 ** (scale_index + 2)
        return 8 if res <= 128 else 1
    n = int(v)
    if n < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {n}")
    return n


def fade_in_real(img: torch.Tensor, alpha) -> torch.Tensor:
    """The real fade-in of scale > 0 (`step.py:258-277`): NHWC uint8 or
    float → f32 (1-α)·upscale2d(downscale2d(real)) + α·real, NHWC."""
    real = normalize_images(img).permute(0, 3, 1, 2)
    return blend(upscale2d(downscale2d(real)), real, alpha).permute(0, 2, 3, 1)


@torch.no_grad()
def eval_losses(G: Generator, D: Discriminator, real: torch.Tensor, z: torch.Tensor,
                alpha: float, *, w_adv: float, fade_real: bool,
                compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The validation forward (`trainer.py:598-625`): the reals faded as
    the step fades them when `fade_real` (scale > 0), D on the
    reals, G on z, D on the fakes; returns 0-d f32 tensors (mean real
    logit, mean fake logit, BCE(real, 1) + BCE(fake, 0), the G loss).
    R1, GP and drift are training regularizers and are left out."""
    real = fade_in_real(real, alpha) if fade_real else normalize_images(real)
    logit_real = D(real, alpha, compute_dtype=compute_dtype)
    fake = G(z, alpha, compute_dtype=compute_dtype)
    logit_fake = D(fake, alpha, compute_dtype=compute_dtype)
    l_d = bce_with_logits(logit_real, 1) + bce_with_logits(logit_fake, 0)
    return (logit_real.float().mean(), logit_fake.float().mean(), l_d,
            generator_loss(logit_fake, w_adv))


def _grads(net: torch.nn.Module) -> List[torch.Tensor]:
    """The gradients a backward left on `net`'s weights, in parameter order
    (the same list on every rank: the ranks run the same graph)."""
    return [p.grad for p in net.parameters() if p.grad is not None]


def make_train_step(cfg, scale_index: int, *, include_r1: Optional[bool] = None,
                    r1_scale: Optional[float] = None,
                    grad_sync: Optional[Callable[[List[torch.Tensor]], None]] = None,
                    rank: int = 0, world_size: int = 1) -> Callable:
    """Build the step for one progressive scale. Returns
    step(state, img_real, alpha, *, z1=None, z2=None, eps=None) →
    (metrics, (real, fake)): metrics a dict of 0-d tensors (L_D, L_D_real,
    L_D_fake, L_D_r1 or L_D_gp and L_D_eps, L_G); real the faded real
    batch (f32, NHWC, in [-1, 1]) and fake the G-phase images (NHWC, in the
    compute dtype), both detached and on the step's device, for the sample
    grid (`step.py:399`).

    `include_r1` (loss_mode 'r1'): None or True applies the penalty, False
    leaves it out (the tail of a lazy window). `r1_scale` multiplies the
    penalty; None → r1_interval, the JAX package's default for its static
    programs (`step.py:208-214`); a 0-d f32 tensor is read at each call (a
    captured lead step's window length). `alpha` may be a float or a 0-d
    f32 tensor on the step's device.

    `grad_sync(grads)`, when given, runs on each network's gradients between
    its `backward` and its optimizer step; `rank` and `world_size` place this
    step's rows in the global batch (see the module docstring). z₁, z₂ and
    eps given to the step are this rank's rows."""
    if not 0 <= int(rank) < int(world_size):
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    rank, world_size = int(rank), int(world_size)
    latent_dim = int(cfg.latent_dim)
    w_adv, w_gp, w_drift = float(cfg.W_adv), float(cfg.W_gp), float(cfg.W_drift_D)
    loss_mode = str(cfg.loss_mode)
    if loss_mode not in ("r1", "wgangp"):
        raise ValueError(f"unknown loss mode {loss_mode!r}")
    r1_target = str(cfg.r1_target)
    with_r1 = include_r1 is None or bool(include_r1)
    r1_mult = (r1_scale if isinstance(r1_scale, torch.Tensor) else
               float(r1_scale) if r1_scale is not None else float(cfg.r1_interval))
    apply_mbn = bool(cfg.apply_minibatch_norm)
    ema_decay = float(cfg.g_ema_decay)
    dt = torch.bfloat16 if str(cfg.compute_dtype) == "bfloat16" else torch.float32

    def step(state: TrainState, img_real: torch.Tensor, alpha, *,
             z1: Optional[torch.Tensor] = None, z2: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None
             ) -> Tuple[Metrics, Tuple[torch.Tensor, torch.Tensor]]:
        G, D = state.G, state.D
        device = next(G.parameters()).device
        batch = img_real.shape[0]

        def draw(shape, fn, given):
            if given is not None:
                return given.to(device=device, dtype=torch.float32)
            full = fn((world_size * shape[0],) + shape[1:], generator=state.rng,
                      device=device)
            return full[rank * shape[0]:(rank + 1) * shape[0]] if world_size > 1 else full
        z1 = draw((batch, latent_dim), torch.randn, z1)
        z2 = draw((batch, latent_dim), torch.randn, z2)
        eps = draw((batch,), torch.rand, eps)

        # ---- real fade-in (NHWC in and out; the ops see channels_last) ----
        img_real = img_real.to(device)
        real = fade_in_real(img_real, alpha) if scale_index > 0 else normalize_images(img_real)

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
            # sums over the batch: W times this rank's, so the ranks' mean
            # is the global batch's sum
            gp = (gradient_penalty(d_fn, real, fake, eps, w_gp * world_size) if w_gp
                  else torch.zeros((), device=device))
            drift = (drift_loss(pred_real, w_drift * world_size) if w_drift
                     else torch.zeros((), device=device))
            loss_d = l_real + l_fake + gp + drift
            metrics.update(L_D_real=l_real, L_D_fake=l_fake, L_D_gp=gp,
                           L_D_eps=drift, L_D=loss_d)
        state.opt_D.zero_grad(set_to_none=True)
        loss_d.backward(inputs=list(D.parameters()))
        if grad_sync is not None:
            grad_sync(_grads(D))
        state.opt_D.step()

        # ---- G phase, against the updated D; D collects no gradient ----
        fake2 = G(z2, alpha, compute_dtype=dt)
        loss_g = generator_loss(d_fn(fake2), w_adv)
        state.opt_G.zero_grad(set_to_none=True)
        loss_g.backward(inputs=list(G.parameters()))
        if grad_sync is not None:
            grad_sync(_grads(G))
        state.opt_G.step()
        metrics["L_G"] = loss_g

        if ema_decay > 0.0 and state.G_ema is not None:
            with torch.no_grad():
                for e, p in zip(state.G_ema.state_dict().values(),
                                G.state_dict().values()):
                    e.mul_(ema_decay).add_(p.to(e.dtype), alpha=1.0 - ema_decay)
        return ({k: v.detach() for k, v in metrics.items()},
                (real.detach(), fake2.detach()))

    return step
