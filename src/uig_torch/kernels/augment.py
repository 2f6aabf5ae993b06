"""Image pre- and post-processing. Images are NHWC.

The serving half (``center_crop_normalize``, ``denormalize_to_u8``,
``_normalize``) is the port's copy of the JAX package's ``kernels/augment.py``
in plain PyTorch: the JAX package runs it in XLA, not Pallas.

The training half, ``augment_batch``, is the random crop + flip + normalize
of ``augment_batch_pallas`` (``kernels/augment_pallas.py``): the CUDA kernel
in ``csrc/augment.cu`` with its plain PyTorch version, writing fp32 or bf16
(the compute dtype: ``x * 2/255 - 1`` in fp32, rounded once, as JAX's
``out_dtype``). The offsets and flips are given, not drawn inside the
kernel, and reach it as kernel parameters from host memory, so a launch
copies nothing to the card and waits for nothing; ``draw_augment`` draws
them from a ``torch.Generator`` with the JAX function's ranges.
"""

from __future__ import annotations

import torch

from uig_torch.kernels import _build
from uig_torch.kernels._check import FLOAT_TYPES, on_cpu

_MAX_BATCH = 64  # examples a launch: csrc/augment.cu refuses more


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


def draw_augment(gen: torch.Generator, batch: int, height: int, width: int,
                 crop: int):
    """Per-example crop offsets and flips, as ``augment_batch`` draws them
    in JAX: ``oy`` in [0, H - crop], ``ox`` in [0, W - crop], ``flip`` a
    fair coin. CPU tensors."""
    oy = torch.randint(0, height - crop + 1, (batch,), generator=gen)
    ox = torch.randint(0, width - crop + 1, (batch,), generator=gen)
    do_flip = torch.rand((batch,), generator=gen) < 0.5
    return oy, ox, do_flip


def augment_batch_reference(images: torch.Tensor, oy: torch.Tensor,
                            ox: torch.Tensor, flip: torch.Tensor, crop: int,
                            out_dtype=torch.float32) -> torch.Tensor:
    b = images.shape[0]
    ar = torch.arange(crop, device=images.device)
    rows = oy.to(images.device).long()[:, None] + ar            # (B, crop)
    j = torch.where(flip.to(images.device).bool()[:, None], crop - 1 - ar, ar)
    cols = ox.to(images.device).long()[:, None] + j             # (B, crop)
    bidx = torch.arange(b, device=images.device)[:, None, None]
    patch = images[bidx, rows[:, :, None], cols[:, None, :]]    # (B, c, c, C)
    return _normalize(patch, out_dtype)


def augment_batch(images: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                  flip: torch.Tensor, crop: int,
                  out_dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, C) -> ``out_dtype`` (fp32 or bf16) (B, crop, crop,
    C) in [-1, 1]: example ``b`` is the crop at rows ``oy[b]:``, columns
    ``ox[b]:``, mirrored left to right where ``flip[b]``, then
    ``x * 2/255 - 1``."""
    if images.dim() != 4 or images.dtype != torch.uint8:
        raise ValueError(f"augment_batch: images must be uint8 (B, H, W, C), "
                         f"got {images.dtype} {tuple(images.shape)}")
    b, h, w, c = images.shape
    if h < crop or w < crop:
        raise ValueError(f"augment_batch: crop {crop} exceeds input {h}x{w}")
    if out_dtype not in FLOAT_TYPES:
        raise TypeError(f"augment_batch: out_dtype must be float32 or "
                        f"bfloat16, got {out_dtype}")
    for name, t in (("oy", oy), ("ox", ox), ("flip", flip)):
        if tuple(t.shape) != (b,):
            raise ValueError(f"augment_batch: {name} must have shape ({b},)")
    ys, xs = [int(v) for v in oy.tolist()], [int(v) for v in ox.tolist()]
    if b and (min(ys) < 0 or max(ys) > h - crop or min(xs) < 0
              or max(xs) > w - crop):
        raise ValueError("augment_batch: crop offset out of range")
    if on_cpu("augment_batch", images):
        return augment_batch_reference(images, oy, ox, flip, crop, out_dtype)
    if not images.is_contiguous():
        raise ValueError("augment_batch: images must be contiguous (NHWC)")
    flips = [int(bool(v)) for v in flip.tolist()]
    y = torch.empty((b, crop, crop, c), device=images.device, dtype=out_dtype)
    with torch.cuda.device(images.device):
        for b0 in range(0, b, _MAX_BATCH):
            s = slice(b0, b0 + _MAX_BATCH)
            # oy, ox, flip in host memory: the kernel takes them as parameters
            meta = torch.tensor(ys[s] + xs[s] + flips[s], dtype=torch.int32)
            _build.launch("uig_augment", images[s], meta, y[s], len(ys[s]),
                          h, w, c, crop, out_dtype == torch.bfloat16)
            augment_batch.launches += 1
    return y


augment_batch.launches = 0
