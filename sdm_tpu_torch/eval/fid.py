"""Frechet (FID-style) and kernel (KID-style) distances between feature sets
(the port's own copy of sdm_tpu/eval/fid.py, which it does not import).

Pure numpy: the expensive part of evaluation is the feature extraction
(features.py, on the device); these O(d^3) statistics run once per
evaluation on the host. No scipy: the matrix square root inside the Frechet
distance comes from a symmetric eigendecomposition of S1^(1/2) S2 S1^(1/2)
(the same trace as sqrtm(S1 S2), but of a PSD-symmetric matrix, so
`numpy.linalg.eigh` suffices and is numerically stable).

Formulas follow Heusel et al. 2017 (FID) and Binkowski et al. 2018 (KID,
unbiased MMD^2 with the polynomial kernel (x.y/d + 1)^3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, covariance) of an (N, D) feature matrix, float64."""
    f = np.asarray(features, np.float64)
    if f.ndim != 2:
        raise ValueError(f"features must be (N, D), got {f.shape}")
    if f.shape[0] < 2:
        raise ValueError("need at least 2 samples for covariance")
    mu = f.mean(axis=0)
    cov = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(cov)


def _psd_sqrt(mat: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Symmetric PSD square root via eigh; tiny negative eigenvalues from
    roundoff are clamped to zero."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """||mu1-mu2||^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)).

    tr(sqrtm(S1 S2)) is evaluated as tr(sqrtm(S1^(1/2) S2 S1^(1/2)))
    (similar matrices share eigenvalues), keeping everything symmetric."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2
    s1_half = _psd_sqrt(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    vals = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = np.sqrt(np.clip(vals, 0.0, None)).sum()
    fd = float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
               - 2.0 * tr_sqrt)
    # Roundoff can leave a tiny negative value for identical inputs.
    return max(fd, 0.0)


def frechet_from_features(feat1: np.ndarray, feat2: np.ndarray) -> float:
    m1, s1 = gaussian_stats(feat1)
    m2, s2 = gaussian_stats(feat2)
    return frechet_distance(m1, s1, m2, s2)


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def kernel_distance(feat1: np.ndarray, feat2: np.ndarray,
                    block_size: int = 1024,
                    seed: int = 0) -> Tuple[float, float]:
    """Unbiased KID (MMD^2, polynomial kernel) -> (mean, std over blocks).

    Features are split into equal-size blocks (subsampled to the shorter
    set's length when sizes differ) and the unbiased estimator is averaged —
    the standard KID protocol, which also yields an uncertainty."""
    f1 = np.asarray(feat1, np.float64)
    f2 = np.asarray(feat2, np.float64)
    if f1.ndim != 2 or f2.ndim != 2 or f1.shape[1] != f2.shape[1]:
        raise ValueError(f"feature shapes mismatch: {f1.shape} vs {f2.shape}")
    rng = np.random.default_rng(seed)
    n = min(len(f1), len(f2))
    if len(f1) > n:
        f1 = f1[rng.choice(len(f1), n, replace=False)]
    if len(f2) > n:
        f2 = f2[rng.choice(len(f2), n, replace=False)]
    bs = min(block_size, n)
    n_blocks = max(n // bs, 1)
    vals = []
    for b in range(n_blocks):
        x = f1[b * bs:(b + 1) * bs]
        y = f2[b * bs:(b + 1) * bs]
        m = len(x)
        kxx = _poly_kernel(x, x)
        kyy = _poly_kernel(y, y)
        kxy = _poly_kernel(x, y)
        # Unbiased: drop diagonals of the within-set terms.
        sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
        sum_yy = (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
        sum_xy = kxy.mean()
        vals.append(sum_xx + sum_yy - 2.0 * sum_xy)
    vals = np.asarray(vals)
    return float(vals.mean()), float(vals.std())
