"""Inception Score, in PyTorch: the port of the JAX package's
``eval/is_score.py``.

IS = exp(E_x KL(p(y|x) || p(y))), reported as mean ± std over equal splits.
It needs class probabilities, i.e. the InceptionV3 ``fc`` head: weights
with ``params/fc/...`` in ``eval.inception_weights``; the random-feature
extractor has no classes. The logits come from the device; the softmax
and the score are the JAX package's numpy code, in float64 on the host.
One process only (ROADMAP §1 item 12).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from uig_torch.eval.fid import _refuse_multiprocess


def inception_score_from_probs(probs: np.ndarray, splits: int = 10,
                               eps: float = 1e-16) -> tuple[float, float]:
    """probs: (N, C), rows on the simplex. Returns (mean, std) over splits."""
    probs = np.asarray(probs, np.float64)
    n = probs.shape[0]
    if n < splits:
        raise ValueError(f"IS with splits={splits} needs >= that many "
                         f"samples, got {n}")
    scores = []
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        py = part.mean(0)
        kl = (part * (np.log(part + eps) - np.log(py + eps))).sum(1).mean()
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))


def compute_inception_score(batches: Iterable, logits_fn: Callable,
                            splits: int = 10) -> tuple[float, float]:
    """IS of one image stream. ``logits_fn``: (B, H, W, 3) -> (B, C) class
    logits on the device (the softmax happens here, in float64 on the
    host)."""
    _refuse_multiprocess()
    ps = []
    for b in batches:
        lg = logits_fn(b).detach().to("cpu", torch.float32).numpy()
        lg = lg.astype(np.float64)
        lg -= lg.max(axis=1, keepdims=True)
        e = np.exp(lg)
        ps.append(e / e.sum(axis=1, keepdims=True))
    if not ps:
        raise ValueError("empty image stream for Inception Score")
    return inception_score_from_probs(np.concatenate(ps, 0), splits=splits)
