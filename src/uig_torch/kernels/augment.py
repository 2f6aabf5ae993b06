"""Deterministic serving pre- and post-processing in plain PyTorch.

The port's copy of ``center_crop_normalize``, ``denormalize_to_u8`` and
``_normalize`` from the JAX package's ``kernels/augment.py``. The JAX package
runs these in XLA, not Pallas, so library ops are the right tool here.
Images are NHWC.
"""

from __future__ import annotations

import torch


def _normalize(x: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] -> out_dtype [-1, 1]."""
    return (x.to(torch.float32) * (2.0 / 255.0) - 1.0).to(out_dtype)


def denormalize_to_u8(x: torch.Tensor) -> torch.Tensor:
    """float [-1,1] -> uint8 [0,255]; rounds half to even like jnp.round."""
    y = (x.to(torch.float32) + 1.0) * (255.0 / 2.0)
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def center_crop_normalize(images: torch.Tensor, crop: int,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Center crop (B, H, W, C) uint8 to (B, crop, crop, C) and normalize."""
    _, h, w, _ = images.shape
    y0 = (h - crop) // 2
    x0 = (w - crop) // 2
    patch = images[:, y0:y0 + crop, x0:x0 + crop, :]
    return _normalize(patch, out_dtype).contiguous()
