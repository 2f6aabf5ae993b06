"""GAN, cycle, identity and L1 losses, in PyTorch.

The port of the JAX package's ``train/losses.py`` (``gan_loss_g``,
``gan_loss_d``, ``cycle_loss``, ``identity_loss``, ``l1_loss``,
``patch_nce_loss``). Every loss is computed
in fp32 whatever the compute dtype. A logit argument may be one map or a
tuple/list of maps (multi-scale PatchGAN), whose losses sum over scales.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def gan_loss_g(fake_logits, mode: str = "lsgan") -> torch.Tensor:
    """Generator-side adversarial loss: make D(fake) read as real."""
    if isinstance(fake_logits, (tuple, list)):
        return sum(gan_loss_g(f, mode) for f in fake_logits)
    y = _f32(fake_logits)
    if mode == "lsgan":
        return torch.mean(torch.square(y - 1.0))
    if mode == "vanilla":
        return torch.mean(F.softplus(-y))  # -log sigmoid(y)
    if mode in ("hinge", "wgan"):
        return -torch.mean(y)
    raise ValueError(f"unknown gan mode {mode!r}")


def gan_loss_d(real_logits, fake_logits, mode: str = "lsgan") -> torch.Tensor:
    """Discriminator adversarial loss, 0.5-weighted as in the CycleGAN
    recipe (wgan carries no 0.5)."""
    if isinstance(real_logits, (tuple, list)):
        return sum(gan_loss_d(r, f, mode)
                   for r, f in zip(real_logits, fake_logits))
    r, f = _f32(real_logits), _f32(fake_logits)
    if mode == "lsgan":
        return 0.5 * (torch.mean(torch.square(r - 1.0))
                      + torch.mean(torch.square(f)))
    if mode == "vanilla":
        return 0.5 * (torch.mean(F.softplus(-r)) + torch.mean(F.softplus(f)))
    if mode == "hinge":
        return 0.5 * (torch.mean(torch.relu(1.0 - r))
                      + torch.mean(torch.relu(1.0 + f)))
    if mode == "wgan":
        return torch.mean(f) - torch.mean(r)
    raise ValueError(f"unknown gan mode {mode!r}")


def cycle_loss(real: torch.Tensor, reconstructed: torch.Tensor) -> torch.Tensor:
    """L1 cycle consistency |F(G(x)) - x|_1, as a mean."""
    return torch.mean(torch.abs(_f32(reconstructed) - _f32(real)))


def identity_loss(real: torch.Tensor, same: torch.Tensor) -> torch.Tensor:
    """L1 identity mapping |G(y) - y|_1, as a mean."""
    return torch.mean(torch.abs(_f32(same) - _f32(real)))


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mean |a - b|: the VQGAN reconstruction loss."""
    return torch.mean(torch.abs(_f32(a) - _f32(b)))


def patch_nce_loss(feat_q: torch.Tensor, feat_k: torch.Tensor,
                   temperature: float = 0.07) -> torch.Tensor:
    """PatchNCE (CUT): ``feat_q`` (B, N, D) projected features of the
    translated patches (queries), ``feat_k`` (B, N, D) those of the input
    patches at the same spatial ids (keys). For each (b, n) the positive is
    the key at n and the negatives are the other N - 1 keys of the same
    image. fp32 from the first cast; one (N, N) product per image, which
    runs without TF32 under the trainers' ``exact_fp32``/``exact_bf16``."""
    q, k = _f32(feat_q), _f32(feat_k)
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-10)
    k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-10)
    logits = torch.bmm(q, k.transpose(1, 2)) / temperature
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.diagonal(logp, dim1=1, dim2=2))
