"""Exponential moving average of the generator parameters: the port of the
JAX package's ``train/ema.py`` ``ema_update``. fp32; updates in place."""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def ema_update(ema: dict, params: dict, decay: float) -> dict:
    """ema <- decay * ema + (1 - decay) * params, for every tensor of the
    (nested) dicts, in place; returns ``ema``. Both coefficients are the
    fp32 values JAX uses: float32(decay) and 1 - float32(decay) in fp32."""
    d = np.float32(decay)
    _update(ema, params, float(d), float(np.float32(1.0) - d))
    return ema


def _update(ema: dict, params: dict, d: float, one_minus: float) -> None:
    for k, e in ema.items():
        p = params[k]
        if isinstance(e, dict):
            _update(e, p, d, one_minus)
        else:
            e.copy_(d * e.to(torch.float32) + one_minus * p.to(torch.float32))
