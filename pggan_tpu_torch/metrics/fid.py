"""FID (Fréchet Inception Distance) — the counterpart of
`pggan_tpu/metrics/fid.py`:

  * `frechet_distance`: the exact Fréchet distance between two Gaussians in
    host float64 numpy (eigenvalues of Σ₁Σ₂), a copy of the JAX package's;
  * `frechet_distance_device`: the same distance on the tensors' device in
    f32, with a Newton–Schulz matrix square root (matmuls only);
  * `RandomConvFeatures`: the default extractor, a fixed-seed random
    convolutional projection (4 × [3×3 conv, stride 2, relu], then a
    global mean pool);
  * `compute_activations` / `compute_activation_statistics` /
    `fid_between_sets`: batches → features → (μ, Σ) → FID.

Random-feature Fréchet distances are a reproducible two-sample discrepancy,
not comparable with Inception-FID numbers. The fixed-seed weights here are
drawn by torch, not by JAX's threefry stream, so a `random_conv` FID of the
port is not comparable with the JAX package's either: compare values of
one package only.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------

def _sqrtm_newton_schulz(a: torch.Tensor, num_iters: int = 30) -> torch.Tensor:
    """Matrix square root by Newton–Schulz iteration (`fid.py:36-51`)."""
    dim = a.shape[0]
    norm = torch.sqrt(torch.sum(a * a))
    y = a / norm
    z = torch.eye(dim, dtype=a.dtype, device=a.device)
    eye3 = 3.0 * torch.eye(dim, dtype=a.dtype, device=a.device)
    for _ in range(num_iters):
        t = 0.5 * (eye3 - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """‖μ₁−μ₂‖² + Tr(Σ₁ + Σ₂ − 2·sqrtm(Σ₁Σ₂)), host float64.

    Tr(sqrtm(Σ₁Σ₂)) = Σ √λᵢ(Σ₁Σ₂), the eigenvalues of the product clamped
    at 0; `eps·I` regularises rank-deficient sample covariances.
    """
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    dim = mu1.shape[0]
    s1 = np.asarray(sigma1, np.float64) + np.eye(dim) * eps
    s2 = np.asarray(sigma2, np.float64) + np.eye(dim) * eps
    diff = mu1 - mu2
    eigvals = np.linalg.eigvals(s1 @ s2)
    tr_sqrt = np.sqrt(np.clip(eigvals.real, 0.0, None)).sum()
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_sqrt)


def frechet_distance_device(mu1: torch.Tensor, sigma1: torch.Tensor,
                            mu2: torch.Tensor, sigma2: torch.Tensor,
                            num_iters: int = 30, eps: float = 1e-3) -> torch.Tensor:
    """The Fréchet distance in f32 on the inputs' device, a 0-d tensor
    (`fid.py:75-89`); f32 needs the larger eps for its conditioning."""
    diff = (mu1 - mu2).float()
    eye = torch.eye(sigma1.shape[0], dtype=torch.float32, device=sigma1.device) * eps
    s1 = sigma1.float() + eye
    s2 = sigma2.float() + eye
    covmean = _sqrtm_newton_schulz(s1 @ s2, num_iters)
    return (torch.sum(diff * diff) + torch.trace(s1) + torch.trace(s2)
            - 2.0 * torch.trace(covmean))


# ---------------------------------------------------------------------------
# Feature extractors
# ---------------------------------------------------------------------------

def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) zero padding of XLA's "SAME" along one axis: the output
    has ceil(size / stride) positions, and an odd total pads one more at
    the high end (so a 3-wide, stride-2 window pads an even size (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class RandomConvFeatures(nn.Module):
    """Fixed-seed random conv feature extractor (the default FID backbone).

    4 × [conv3x3 stride 2 ("SAME" padding) + relu] with widths (64, 128,
    256, feature_dim), then a global mean pool. He-initialised weights from
    a `torch.Generator` seeded with `seed`, so the metric is the same on
    every run, machine and device (the draws are made on the CPU).
    """

    def __init__(self, feature_dim: int = 512, seed: int = 2020,
                 input_channels: int = 3, device="cuda"):
        super().__init__()
        widths = [64, 128, 256, feature_dim]
        gen = torch.Generator().manual_seed(int(seed))
        weights = []
        c_in = input_channels
        for c_out in widths:
            w = torch.randn((c_out, c_in, 3, 3), generator=gen) * np.sqrt(2.0 / (9 * c_in))
            weights.append(nn.Parameter(w, requires_grad=False))
            c_in = c_out
        # OIHW; the JAX package's HWIO arrays load as w.transpose(3, 2, 0, 1)
        self.weights = nn.ParameterList(weights)
        self.feature_dim = feature_dim
        self.to(device=device, memory_format=torch.channels_last).eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC in [-1, 1] → [B, feature_dim] f32."""
        x = images.float().permute(0, 3, 1, 2)
        for w in self.weights:
            (top, bottom), (left, right) = (same_pads(n, 3, 2) for n in x.shape[2:])
            x = F.relu(F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=2))
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# Statistics + end-to-end FID
# ---------------------------------------------------------------------------

def compute_activations(batches: Iterable, extractor: Callable, *,
                        max_samples: Optional[int] = None) -> np.ndarray:
    """Stream batches (NHWC in [-1, 1] or uint8; numpy arrays or tensors)
    through the extractor on the device of its weights (the CPU for a
    callable without) → f32 feature matrix [n, D] on the host. The raw features feed both FID (→ μ, Σ) and KID, so one
    extraction pass serves every metric. Features are per sample, so a
    ragged last batch runs as it is."""
    weights = extractor.parameters() if isinstance(extractor, nn.Module) else ()
    device = next(iter(weights), torch.empty(0)).device
    feats: List[np.ndarray] = []
    seen = 0
    with torch.inference_mode():
        for batch in batches:
            x = torch.as_tensor(batch).to(device, non_blocking=True)
            if x.dtype == torch.uint8:
                x = x.float() / 127.5 - 1.0
            feats.append(extractor(x).float().cpu().numpy())
            seen += x.shape[0]
            if max_samples is not None and seen >= max_samples:
                break
    f = np.concatenate(feats, axis=0)
    if max_samples is not None:
        f = f[:max_samples]
    return f


def compute_activation_statistics(batches: Iterable, extractor: Callable, *,
                                  max_samples: Optional[int] = None
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Stream batches (NHWC in [-1, 1] or uint8) → (μ [D], Σ [D, D])."""
    f = compute_activations(batches, extractor, max_samples=max_samples)
    return f.mean(axis=0), np.cov(f, rowvar=False)


def fid_between_sets(real_batches: Iterable, fake_batches: Iterable,
                     extractor: Optional[Callable] = None, *,
                     max_samples: Optional[int] = None, device="cuda") -> float:
    """FID between two image streams; the extractor defaults to
    `RandomConvFeatures()` on `device`."""
    if extractor is None:
        extractor = RandomConvFeatures(device=device)
    mu1, s1 = compute_activation_statistics(real_batches, extractor,
                                            max_samples=max_samples)
    mu2, s2 = compute_activation_statistics(fake_batches, extractor,
                                            max_samples=max_samples)
    return frechet_distance(mu1, s1, mu2, s2)
