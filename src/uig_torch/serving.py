"""The serving translator: uint8 (n, load, load, 3) in, uint8 (n, crop,
crop, 3) out, through center crop + normalize, the fp32 generator and
denormalize, on the card.

The port's counterpart of the JAX package's ``ExportedTranslator`` over
``export_translate``: the same static batch with the pad-the-tail-then-trim
policy and the same ``.batch`` / ``.meta`` keys. Weights come from a flat
flax ``.npz`` (``uig_torch.convert``).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from uig_torch.config import apply_overrides, get_preset, load_config
from uig_torch.convert import generator_state_from_flax, load_generator_npz
from uig_torch.kernels.augment import center_crop_normalize, denormalize_to_u8
from uig_torch.models import generator_from_config
from uig_torch.runtime import resolve_device


def load_serving_config(config: str, overrides=()):
    """A preset name or a ``config.json`` path (as a JAX run writes it)."""
    cfg = load_config(config) if config.endswith(".json") else get_preset(config)
    return apply_overrides(cfg, list(overrides)) if overrides else cfg


@contextlib.contextmanager
def exact_fp32():
    """fp32 without TF32 for cuDNN convs and matmuls, deterministic cuDNN
    algorithms, scoped: the counterpart of the JAX serving path's
    ``default_matmul_precision("highest")``."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


class Translator:
    """``y_u8 = translator(x_u8)`` for the CycleGAN generator of ``config``.

    ``config``: preset name or ``config.json``. ``weights``: flat flax
    ``.npz`` of one generator; ``direction`` names the direction it
    translates, for ``.meta``. Runs on ``device`` (the card by default; ``"cpu"`` runs the plain
    PyTorch versions of every kernel). Call it from one thread at a time:
    ``exact_fp32`` sets process-wide flags for the duration of a call (the
    server's single dispatcher thread serializes calls)."""

    def __init__(self, config: str, weights: str, direction: str = "a2b",
                 batch_size: int = 8, device: str = "cuda", overrides=()):
        if direction not in ("a2b", "b2a"):
            raise ValueError(f"direction must be a2b or b2a, got {direction!r}")
        self.device = resolve_device(device)
        self.cfg = load_serving_config(config, overrides)
        self.generator = generator_from_config(self.cfg.model)
        state = generator_state_from_flax(load_generator_npz(weights),
                                          self.generator)
        self.generator.load_state_dict(state, strict=True)
        self.generator.to(self.device).eval().requires_grad_(False)
        self.batch = batch_size
        self.crop = self.cfg.model.image_size
        self.load = self.cfg.data.load_size
        self.meta = {
            "kind": self.cfg.model.kind,
            "direction": direction,
            "target_domain": None,
            "style_seed": None,
            "input": [batch_size, self.load, self.load, 3],
            "input_dtype": "uint8",
            "output": [batch_size, self.crop, self.crop, 3],
            "output_dtype": "uint8",
            "eval_dtype": self.cfg.model.eval_dtype,
            "platforms": [self.device.type],
            "weights": os.path.abspath(weights),
            "preset": self.cfg.run.name,
        }

    def translate_float(self, x: torch.Tensor) -> torch.Tensor:
        """[-1, 1] NHWC fp32 on the device -> the generator's output."""
        with torch.inference_mode(), exact_fp32():
            return self.generator(x)

    def __call__(self, raw_u8: np.ndarray) -> np.ndarray:
        n = raw_u8.shape[0]
        if n == 0 or n > self.batch:
            raise ValueError(f"batch {n} out of range for static batch "
                             f"{self.batch}")
        expect = (self.load, self.load, 3)
        if tuple(raw_u8.shape[1:]) != expect or raw_u8.dtype != np.uint8:
            raise ValueError(f"expected uint8 (n, {self.load}, {self.load}, 3), "
                             f"got {raw_u8.dtype} {raw_u8.shape}")
        pad = self.batch - n
        if pad:
            raw_u8 = np.concatenate([raw_u8, np.repeat(raw_u8[-1:], pad, 0)])
        with torch.inference_mode(), exact_fp32():
            raw = torch.from_numpy(np.ascontiguousarray(raw_u8)).to(self.device)
            x = center_crop_normalize(raw, self.crop)
            out = denormalize_to_u8(self.generator(x))
            return out.cpu().numpy()[:n]
