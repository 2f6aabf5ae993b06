"""LPIPS perceptual distance, in PyTorch: the port of the JAX package's
``eval/lpips.py``.

Three pieces, as there:

1. a fixed scaling layer, ``(x - LPIPS_SHIFT) / LPIPS_SCALE``, from [-1, 1]
   pixels to the statistics the VGG backbone was trained on;
2. ``VGG16Features``: the 13 3x3 SAME convs of VGG16 with ReLU and VALID
   2x2 max pools, tapped after the last ReLU of each of the 5 stages, each
   tap unit-normalized over its channels (rsqrt of sum f^2 + 1e-10);
3. the lin stage: with ``eval.lpips_lin_weights`` (the published per-layer
   channel weights, ``lin0`` ... ``lin4``), the weighted squared difference
   summed over channels, averaged over batch and space, summed over the
   layers; without it, equal channel weights and the average of the layers.

The VGG's parameters keep flax's names and layouts (``conv0`` ...
``conv12``, HWIO kernels), so JAX's parameters cross by a rename
(``uig_torch.convert``). They take no gradient, as JAX closes over them.
The distance runs in fp32 whatever its inputs' type, as JAX casts to fp32,
and on the card under ``serving.exact_fp32`` (TF32 off); its convs are
library convs, as JAX leaves them to XLA.

Weights: ``eval.vgg_weights`` names an ``.npz`` with the keys JAX's
``_load_flat`` reads (``params/conv{i}/kernel`` and ``.../bias``). Without
it the VGG is drawn from a seed with flax's default initializers
(lecun-normal kernels, zero biases; ``convert.seeded_flax``). torch cannot
reproduce ``jax.random``'s bits, so a port run and a JAX run without a
weight file use different random VGGs; with the same ``.npz`` file both
compute the same term.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from uig_torch.convert import (generator_state_from_flax, load_generator_npz,
                               seeded_flax)
from uig_torch.runtime import resolve_device
from uig_torch.serving import exact_fp32

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)
# official LPIPS ScalingLayer constants (maps [-1,1] to ImageNet-normalized)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
N_LAYERS = 5


class _Conv3(nn.Module):
    """flax's ``nn.Conv(features, (3, 3))``: SAME padding, HWIO kernel,
    bias. NCHW in and out."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias,
                        padding=1)


class VGG16Features(nn.Module):
    """NHWC (B, H, W, 3) -> the 5 stage taps, NHWC, each after its stage's
    last ReLU."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for item in VGG16_CFG:
            if item != "M":
                setattr(self, f"conv{i}", _Conv3(cin, item))
                cin, i = item, i + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        # NCHW-contiguous, unlike the generator's channels_last views: on
        # it cuDNN's deterministic fp32 heuristics take fewer FFT
        # convolutions for the input gradient
        h = x.permute(0, 3, 1, 2).contiguous()
        taps, i = [], 0
        for item in VGG16_CFG:
            if item == "M":
                taps.append(h)
                h = F.max_pool2d(h, 2, 2)
            else:
                h = torch.relu(getattr(self, f"conv{i}")(h))
                i += 1
        taps.append(h)
        return [t.permute(0, 2, 3, 1) for t in taps]


def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    return f * torch.rsqrt(torch.sum(f * f, -1, keepdim=True) + 1e-10)


class LPIPS(nn.Module):
    """``lpips(x, y)`` -> 0-dim fp32: x, y in [-1, 1], NHWC, of one shape.
    ``lins``: the 5 per-layer channel weights, or None for equal weights
    with a layer average. Its gradient is taken under the caller's
    precision flags (the trainers take every gradient under
    ``exact_fp32``/``exact_bf16``)."""

    def __init__(self, vgg: VGG16Features, lins: list | None = None):
        super().__init__()
        self.vgg = vgg.requires_grad_(False)
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT))
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE))
        self.lins = None
        if lins is not None:
            if len(lins) != N_LAYERS:
                raise ValueError(f"LPIPS: {len(lins)} lin weights, want "
                                 f"{N_LAYERS}")
            self.lins = nn.ParameterList(
                nn.Parameter(torch.as_tensor(np.asarray(w, np.float32)),
                             requires_grad=False) for w in lins)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with exact_fp32():
            fx = self.vgg((x.to(torch.float32) - self.shift) / self.scale)
            fy = self.vgg((y.to(torch.float32) - self.shift) / self.scale)
            d = torch.zeros((), device=self.shift.device)
            for i, (a, b) in enumerate(zip(fx, fy)):
                sq = torch.square(_unit_normalize(a) - _unit_normalize(b))
                if self.lins is not None:
                    d = d + torch.mean(torch.sum(sq * self.lins[i], -1))
                else:
                    d = d + torch.mean(torch.sum(sq, -1))
        return d if self.lins is not None else d / N_LAYERS


def vgg_from_flax(flat: dict[str, np.ndarray]) -> VGG16Features:
    """A ``VGG16Features`` holding JAX's flat parameters
    (``params/conv{i}/kernel|bias``); raises on a missing, unused or
    misshapen key."""
    vgg = VGG16Features()
    vgg.load_state_dict(generator_state_from_flax(flat, vgg))
    return vgg


def load_lins(path: str) -> list[np.ndarray]:
    """The ``eval.lpips_lin_weights`` file: ``lin0`` ... ``lin4``, each the
    channel weights of one tap."""
    with np.load(path) as z:
        return [np.asarray(z[f"lin{i}"], np.float32) for i in range(N_LAYERS)]


@functools.lru_cache(maxsize=1)
def _seed0_vgg() -> dict:
    """The seed-0 VGG, drawn once a process (every trainer and evaluation
    in one process shares it)."""
    return seeded_flax(VGG16Features(), 0)


def make_lpips(cfg=None, weights_path: str | None = None,
               lin_path: str | None = None, *,
               device: str = "cuda") -> LPIPS:
    """The LPIPS module on ``device``, as the JAX ``make_lpips`` builds it:
    the VGG from ``weights_path`` (an ``eval.vgg_weights`` ``.npz``) or
    drawn from seed 0; the lin weights from ``lin_path``, else from
    ``cfg.eval.lpips_lin_weights`` when set, else equal weights."""
    if cfg is not None and lin_path is None:
        lin_path = getattr(cfg.eval, "lpips_lin_weights", "") or None
    dev = resolve_device(device)
    flat = (load_generator_npz(weights_path) if weights_path
            else _seed0_vgg())
    lins = load_lins(lin_path) if lin_path else None
    return LPIPS(vgg_from_flax(flat), lins).to(dev)


def trainer_lpips(cfg, device) -> LPIPS | None:
    """A trainer's LPIPS, as the JAX package's ``build_trainer`` makes it:
    ``make_lpips`` of the config (the VGG from ``eval.vgg_weights``, or
    drawn from seed 0) when ``loss.lambda_lpips > 0``, else None."""
    if cfg.loss.lambda_lpips <= 0:
        return None
    return make_lpips(cfg, weights_path=cfg.eval.vgg_weights or None,
                      device=device)
