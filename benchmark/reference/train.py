"""The plain reference of the training step (f32, TF32 off by the caller):
the reals' normalisation and fade, the BCE losses, the R1 penalty through
the double backward, and Adam, written from the published recipe
(yukyeongleee/pggan's `pggan/model.py`; Mescheder et al. 2018 for R1;
Kingma and Ba 2015 for Adam, with PyTorch's placement of eps).

One step:
  1. reals uint8 NHWC → x/127.5 − 1; at scale > 0 faded with their 2×
     average-pooled, nearest-upscaled copy: (1-α)·up(down(x)) + α·x;
  2. D phase: fake = G(z₁), no gradient; L_D = BCE(D(real), 1) +
     BCE(D(fake), 0) + R1, R1 = 0.5·mean_b Σ(∇ₓ Σ D(real))² · r1_scale (no
     W_gp: the reference's call site); a step without R1 leaves it out;
     Adam on D;
  3. G phase against the updated D: L_G = W_adv·BCE(D(G(z₂)), 1); Adam on G.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import model as ref

Params = Dict[str, torch.Tensor]


def bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    x = logits
    return (torch.clamp(x, min=0.0) - x * target + torch.log1p(torch.exp(-x.abs()))).mean()


def fade_reals(images: torch.Tensor, alpha: float, scale: int) -> torch.Tensor:
    x = images.float() / 127.5 - 1.0
    if scale == 0:
        return x
    x = x.permute(0, 3, 1, 2)
    return ref.fade(ref.up2(ref.down2(x)), x, alpha).permute(0, 2, 3, 1)


class Adam:
    """PyTorch's Adam: m ← β1·m + (1-β1)·g, v ← β2·v + (1-β2)·g²,
    p ← p − lr/(1-β1ᵗ) · m / (sqrt(v)/sqrt(1-β2ᵗ) + eps)."""

    def __init__(self, params: Params, lr: float, betas, eps: float):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.sub_(self.lr / bc1 * self.m[k] / denom)


class Reference:
    """G and D weights (f32, copies of the benchmark's) with their Adam
    states; `step` runs one training step on them."""

    def __init__(self, model: dict, g: Params, d: Params, quant: Optional[str] = None):
        self.model = model
        self.scale = int(model["scale"])
        self.d0 = int(model["depths"][0])
        self.quant = ref.QUANTS[quant or "float32"]
        self.g = {k: v.detach().float().clone() for k, v in g.items()}
        self.d = {k: v.detach().float().clone() for k, v in d.items()}
        betas = (float(model["beta1"]), float(model["beta2"]))
        eps = float(model["adam_eps"])
        self.opt_g = Adam(self.g, float(model["lr_G"]), betas, eps)
        self.opt_d = Adam(self.d, float(model["lr_D"]), betas, eps)

    def G(self, p: Params, z: torch.Tensor, alpha: float) -> torch.Tensor:
        return ref.generator(p, z, alpha, self.scale, self.d0, self.quant)

    def D(self, p: Params, x: torch.Tensor, alpha: float) -> torch.Tensor:
        return ref.discriminator(p, x, alpha, self.scale, self.quant)

    @staticmethod
    def _grads(loss: torch.Tensor, params: Params) -> Params:
        """d loss / d params; zero for a layer the scale does not use (the
        toRGB and fromRGB heads of earlier scales)."""
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return {k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(params.items(), grads)}

    def step(self, images: torch.Tensor, z1: torch.Tensor, z2: torch.Tensor,
             alpha: float, r1_scale: Optional[float]) -> Dict[str, float]:
        """One step on uint8 NHWC `images`; `r1_scale` None runs it without
        R1. Returns the step's losses."""
        real = fade_reals(images, alpha, self.scale)
        with torch.no_grad():
            fake = self.G(self.g, z1, alpha)
        d = {k: v.requires_grad_(True) for k, v in self.d.items()}
        if r1_scale is not None:
            x = real.detach().requires_grad_(True)
            pred_real = self.D(d, x, alpha)
            (grad,) = torch.autograd.grad(pred_real.sum(), x, create_graph=True)
            reg = 0.5 * grad.square().reshape(grad.shape[0], -1).sum(dim=1).mean() * r1_scale
        else:
            pred_real = self.D(d, real, alpha)
            reg = torch.zeros((), device=real.device)
        l_real, l_fake = bce(pred_real, 1.0), bce(self.D(d, fake, alpha), 0.0)
        loss_d = l_real + l_fake + reg
        grads = self._grads(loss_d, d)
        for v in d.values():
            v.requires_grad_(False)
        self.opt_d.step(self.d, grads)

        g = {k: v.requires_grad_(True) for k, v in self.g.items()}
        loss_g = float(self.model["W_adv"]) * bce(self.D(self.d, self.G(g, z2, alpha), alpha), 1.0)
        grads = self._grads(loss_g, g)
        for v in g.values():
            v.requires_grad_(False)
        self.opt_g.step(self.g, grads)
        return {"L_D": loss_d.item(), "L_G": loss_g.item(), "L_D_r1": reg.item()}

    def first_moments(self) -> Dict[str, Params]:
        """The gradient of the first step of each network, from Adam's first
        moment after it: m = (1-β1)·g."""
        return {"G": {k: m / (1.0 - self.opt_g.b1) for k, m in self.opt_g.m.items()},
                "D": {k: m / (1.0 - self.opt_d.b1) for k, m in self.opt_d.m.items()}}


def run_steps(model: dict, g: Params, d: Params, batches: Sequence[torch.Tensor],
              latents: Sequence, alpha: float, r1_scales: Sequence[Optional[float]],
              quant: Optional[str] = None) -> dict:
    """The reference over the given steps: each step's losses, the first
    step's gradients and the weights after the last step."""
    reference = Reference(model, g, d, quant)
    losses: List[Dict[str, float]] = []
    grads = None
    for i, (images, (z1, z2), r1) in enumerate(zip(batches, latents, r1_scales)):
        losses.append(reference.step(images, z1, z2, alpha, r1))
        if i == 0:
            grads = reference.first_moments()
    return {"losses": losses, "grads": grads, "params": {"G": reference.g, "D": reference.d}}
