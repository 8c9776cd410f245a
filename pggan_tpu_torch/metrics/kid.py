"""KID (Kernel Inception Distance) — Bińkowski et al. 2018, "Demystifying
MMD GANs" (arXiv:1801.01401); a copy of `pggan_tpu/metrics/kid.py`, which
the port cannot import (the JAX package's `__init__` imports JAX).

KID's MMD² estimator is unbiased at any sample size, so at the small real
sets a progressive run evaluates against, its level (not only its slope)
is a convergence signal; FID's is dominated by the bias of a 2048-d sample
covariance.

Definition: squared maximum mean discrepancy between real and fake feature
distributions under the cubic polynomial kernel

    k(x, y) = (xᵀy / d + 1)³         (d = feature dimension)

with the unbiased estimator (diagonal terms excluded):

    MMD²_u = Σ_{i≠j} k(xᵢ,xⱼ) / (m(m−1)) + Σ_{i≠j} k(yᵢ,yⱼ) / (n(n−1))
             − 2 Σ_{i,j} k(xᵢ,yⱼ) / (mn)

averaged over `n_subsets` random subsets of size `subset_size` (without
replacement within a subset), reporting mean and std; when a side has
fewer samples than `subset_size`, the subset size clamps to the smaller
side (torch-fidelity's convention).

Host float64 numpy on [n, D] feature matrices; the feature extraction is
the card's part (`fid.compute_activations`).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np


def polynomial_kernel(x: np.ndarray, y: np.ndarray, *, degree: int = 3,
                      gamma: Optional[float] = None,
                      coef0: float = 1.0) -> np.ndarray:
    """k(x, y) = (γ·xᵀy + coef0)^degree, γ defaulting to 1/D — the KID
    paper's kernel (§4: cubic, γ=1/d, c=1)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def mmd2_unbiased(f_real: np.ndarray, f_fake: np.ndarray, *,
                  degree: int = 3, gamma: Optional[float] = None,
                  coef0: float = 1.0) -> float:
    """Unbiased MMD² between two feature sets (diagonal self-similarity
    terms excluded on the within-set sums; sizes may differ)."""
    m = f_real.shape[0]
    n = f_fake.shape[0]
    if m < 2 or n < 2:
        raise ValueError(f"unbiased MMD^2 needs >= 2 samples per side, "
                         f"got {m} real / {n} fake")
    k_rr = polynomial_kernel(f_real, f_real, degree=degree, gamma=gamma,
                             coef0=coef0)
    k_ff = polynomial_kernel(f_fake, f_fake, degree=degree, gamma=gamma,
                             coef0=coef0)
    k_rf = polynomial_kernel(f_real, f_fake, degree=degree, gamma=gamma,
                             coef0=coef0)
    sum_rr = (k_rr.sum() - np.trace(k_rr)) / (m * (m - 1))
    sum_ff = (k_ff.sum() - np.trace(k_ff)) / (n * (n - 1))
    sum_rf = k_rf.mean()
    return float(sum_rr + sum_ff - 2.0 * sum_rf)


def kid_between_features(f_real: np.ndarray, f_fake: np.ndarray, *,
                         subset_size: int = 1000, n_subsets: int = 100,
                         seed: int = 0) -> Tuple[float, float]:
    """(KID mean, KID std) over `n_subsets` random subsets.

    `subset_size` clamps to min(len(real), len(fake)); when both sides are
    already ≤ subset_size the subsets degenerate to the full sets, so a
    single evaluation is returned with std 0 (no resampling noise to
    report — the estimator itself is deterministic there).
    """
    f_real = np.asarray(f_real, np.float64)
    f_fake = np.asarray(f_fake, np.float64)
    m = min(subset_size, f_real.shape[0], f_fake.shape[0])
    if m == f_real.shape[0] and m == f_fake.shape[0]:
        return mmd2_unbiased(f_real, f_fake), 0.0
    rs = np.random.RandomState(seed)
    vals = np.empty(n_subsets, np.float64)
    for i in range(n_subsets):
        r = f_real[rs.choice(f_real.shape[0], m, replace=False)]
        f = f_fake[rs.choice(f_fake.shape[0], m, replace=False)]
        vals[i] = mmd2_unbiased(r, f)
    return float(vals.mean()), float(vals.std())


def kid_between_sets(real_batches: Iterable[np.ndarray],
                     fake_batches: Iterable[np.ndarray],
                     extractor: Optional[Callable] = None, *,
                     max_samples: Optional[int] = None,
                     subset_size: int = 1000,
                     n_subsets: int = 100, device="cuda") -> Tuple[float, float]:
    """End-to-end KID between two image streams (NHWC in [-1,1] or uint8),
    mirroring `fid_between_sets`'s interface (the default extractor on
    `device`)."""
    from pggan_tpu_torch.metrics.fid import RandomConvFeatures, compute_activations
    if extractor is None:
        extractor = RandomConvFeatures(device=device)
    f_real = compute_activations(real_batches, extractor,
                                 max_samples=max_samples)
    f_fake = compute_activations(fake_batches, extractor,
                                 max_samples=max_samples)
    return kid_between_features(f_real, f_fake, subset_size=subset_size,
                                n_subsets=n_subsets)
