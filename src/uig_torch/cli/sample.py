"""``python -m uig_torch.cli sample``: unconditional generation. For a
stage-1 ``vqgan`` run that is uniform-random codes decoded by the EMA
decoder; VAE-GAN prior sampling and the VQGAN latent prior are not ported
yet. The port of the JAX package's ``cli/sample.py``."""

from __future__ import annotations

import json
import os
import warnings

import torch

SAMPLING_KINDS = ("vaegan", "vqgan_prior", "vqgan")
UNPORTED = {"vaegan": "item 8, VAE-GAN",
            "vqgan_prior": "item 11, the VQGAN latent prior"}


def draw_codes(n: int, hw: int, codebook_size: int, seed: int
               ) -> torch.Tensor:
    """(n, hw, hw) uniform codes from a ``torch.Generator`` seeded by
    ``seed``: torch cannot reproduce ``jax.random``'s draws, so the same
    seed gives other codes than the JAX package's."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, codebook_size, (n, hw, hw), generator=g)


def run_sample(run_dir: str, output_dir: str, n: int = 16, seed: int = 0,
               step: int | None = None, overrides=(),
               device: str = "cuda") -> int:
    """Write ``n`` samples of the run as ``<output_dir>/00000.png`` ...;
    returns ``n``."""
    from PIL import Image

    from uig_torch.cli.translate import load_run
    from uig_torch.config import apply_overrides, config_from_dict
    from uig_torch.kernels.augment import denormalize_to_u8

    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    kind = apply_overrides(cfg, list(overrides)).model.kind
    if kind not in SAMPLING_KINDS:
        raise ValueError(
            f"model kind {kind!r} has no unconditional sampling path "
            "(use vaegan, vqgan_prior, or vqgan)")
    if kind in UNPORTED:
        raise NotImplementedError(f"sample for model.kind={kind!r} is not "
                                  f"ported yet (ROADMAP §1 {UNPORTED[kind]})")
    cfg, trainer, state = load_run(run_dir, step, overrides, device)
    os.makedirs(output_dir, exist_ok=True)
    warnings.warn(
        "sampling a stage-1 vqgan run decodes UNIFORM-RANDOM codes "
        "(texture noise, not generation) — train a latent prior "
        "(model.kind=vqgan_prior, model.prior_vqgan_run=<this run>) "
        "and sample that run instead", stacklevel=2)
    latent_hw = cfg.model.image_size // (
        2 ** (len(cfg.model.vq_channel_mults) - 1))
    codes = draw_codes(n, latent_hw, cfg.model.vq_codebook_size, seed)
    imgs = trainer.decode_codes(state.ema, codes)
    u8 = denormalize_to_u8(imgs).cpu().numpy()
    for i in range(n):
        Image.fromarray(u8[i]).save(os.path.join(output_dir, f"{i:05d}.png"))
    return n
