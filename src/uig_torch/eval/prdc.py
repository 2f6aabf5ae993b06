"""Precision / Recall / Density / Coverage over feature embeddings: the
port of the JAX package's ``eval/prdc.py``.

Improved precision/recall (Kynkäänniemi et al. 2019, the k-NN manifold
estimate) and density/coverage (Naeem et al. 2020), host-side numpy over
the features FID and KID use (``eval/fid.py`` ``collect_features``); the
numpy code is the JAX package's, copied. With the k-NN radius r_k(x) the
distance to the k-th nearest other point of x's own set:
  precision = fraction of fakes inside any real point's r_k ball
  recall    = fraction of reals inside any fake point's r_k ball
  density   = mean over fakes of (#real balls containing it) / k
  coverage  = fraction of reals whose own r_k ball contains >= 1 fake
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np


def _pairwise_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Euclidean distances, (len(a), len(b)), float64, numerically safe."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d2 = (np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :]
          - 2.0 * (a @ b.T))
    return np.sqrt(np.clip(d2, 0.0, None))


def _knn_radii(x: np.ndarray, k: int) -> np.ndarray:
    """Distance from each point to its k-th nearest neighbor (self excluded)."""
    d = _pairwise_dist(x, x)
    np.fill_diagonal(d, np.inf)
    # k-th smallest (1-indexed) along each row.
    return np.partition(d, k - 1, axis=1)[:, k - 1]


def prdc_from_features(real: np.ndarray, fake: np.ndarray,
                       k: int = 5) -> dict[str, float]:
    """Returns {"precision", "recall", "density", "coverage"} floats."""
    real = np.asarray(real, np.float64)
    fake = np.asarray(fake, np.float64)
    for name, f in (("real", real), ("fake", fake)):
        if f.shape[0] <= k:
            raise ValueError(
                f"PRDC needs more than k={k} {name} samples, got {f.shape[0]}"
                " — lower k or add samples")
    r_radii = _knn_radii(real, k)
    f_radii = _knn_radii(fake, k)
    d_rf = _pairwise_dist(real, fake)  # (n_real, n_fake)

    inside_real_balls = d_rf <= r_radii[:, None]  # real i's ball holds fake j
    inside_fake_balls = d_rf <= f_radii[None, :]  # fake j's ball holds real i

    precision = float(inside_real_balls.any(axis=0).mean())
    recall = float(inside_fake_balls.any(axis=1).mean())
    density = float(inside_real_balls.sum(axis=0).mean() / k)
    coverage = float((d_rf.min(axis=1) <= r_radii).mean())
    return {"precision": precision, "recall": recall,
            "density": density, "coverage": coverage}


def compute_prdc(real_batches: Iterable, fake_batches: Iterable,
                 feature_fn: Callable, k: int = 5) -> dict[str, float]:
    """PRDC between two image streams (the interface of compute_kid)."""
    from uig_torch.eval.fid import collect_features

    real, fake = collect_features(real_batches, fake_batches, feature_fn)
    return prdc_from_features(real, fake, k=k)
