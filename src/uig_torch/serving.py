"""The serving translator: uint8 (n, load, load, 3) in, uint8 (n, crop,
crop, 3) out, through center crop + normalize, the generator and
denormalize, on the card. The generator computes in ``model.eval_dtype``
(float32 under ``exact_fp32``, or bfloat16 under ``exact_bf16`` with the
training forward's casts: fp32 parameters cast at each op). For
``model.kind == "vqgan"`` the generator's output is the reconstruction
through the codebook (translate is reconstruct), and ``decode_codes``
turns codebook indices into images.

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
from uig_torch.convert import (check_state, generator_state_from_flax,
                               load_generator_npz)
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


@contextlib.contextmanager
def exact_bf16():
    """The bf16 training step's precision: everything of ``exact_fp32``
    (the step's fp32 parts stay exact, cuDNN deterministic and without
    autotuning), and cuBLAS bf16 products reduce in fp32, as XLA
    accumulates them. No autocast: the layers cast explicitly."""
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with exact_fp32():
            yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def exact_for(dtype: torch.dtype):
    """The precision scope of a model computing in ``dtype``:
    ``exact_fp32`` for float32, ``exact_bf16`` for bfloat16."""
    return exact_fp32 if dtype == torch.float32 else exact_bf16


class Translator:
    """``y_u8 = translator(x_u8)`` for the generator of ``config`` (CycleGAN,
    CUT, DCLGAN or VQGAN; CUT translates a2b only).

    ``config``: preset name or ``config.json``. ``weights``: flat flax
    ``.npz`` of one generator, or its state dict (tensors keyed as the
    module's, as a checkpoint's EMA holds them; ``from_run_dir``);
    ``direction`` names the direction it translates, for ``.meta``. Runs on
    ``device`` (the card by default; ``"cpu"`` runs the plain PyTorch
    versions of every kernel). Call it from one thread at a time:
    ``exact_fp32`` and ``exact_bf16`` set process-wide flags for the
    duration of a call (the server's single dispatcher thread serializes
    calls)."""

    def __init__(self, config: str, weights, direction: str = "a2b",
                 batch_size: int = 8, device: str = "cuda", overrides=()):
        if direction not in ("a2b", "b2a"):
            raise ValueError(f"direction must be a2b or b2a, got {direction!r}")
        self.device = resolve_device(device)
        self.cfg = load_serving_config(config, overrides)
        if self.cfg.model.kind == "cut" and direction != "a2b":
            raise ValueError("CUT is single-direction (a2b)")
        self.generator = generator_from_config(self.cfg.model)
        if isinstance(weights, dict):
            state = weights
            check_state(state, self.generator)
        else:
            state = generator_state_from_flax(load_generator_npz(weights),
                                              self.generator)
        self.generator.load_state_dict(state, strict=True)
        self.generator.to(self.device).eval().requires_grad_(False)
        self._precision = exact_for(self.generator.dtype)
        self.vqgan = self.cfg.model.kind == "vqgan"
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
            "weights": (os.path.abspath(weights)
                        if isinstance(weights, str) else None),
            "preset": self.cfg.run.name,
        }

    @classmethod
    def from_run_dir(cls, run_dir: str, step: int | None = None,
                     direction: str = "a2b", batch_size: int = 8,
                     device: str = "cuda", overrides=()) -> "Translator":
        """The EMA generator of ``direction`` from a training run of the
        port (``fit``): its ``config.json`` and checkpoint ``step`` (default:
        the newest) under ``ckpt/``."""
        from uig_torch.checkpoint import CheckpointManager

        if load_config(os.path.join(run_dir, "config.json")).model.kind \
                == "cut" and direction != "a2b":
            raise ValueError("CUT is single-direction (a2b)")
        ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
        if step is None:
            step = ckpt.latest_step()
        tensors, _ = ckpt.read(step)
        prefix = f"ema/{direction}/"
        ema = {k[len(prefix):]: t for k, t in tensors.items()
               if k.startswith(prefix)}
        if not ema:
            raise KeyError(f"{run_dir}: checkpoint {step} has no EMA "
                           f"generator for {direction!r}")
        tr = cls(os.path.join(run_dir, "config.json"), ema, direction,
                 batch_size, device, overrides)
        tr.meta["weights"] = f"{os.path.abspath(ckpt.path(step))}:{prefix}"
        return tr

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        y = self.generator(x)
        return y[0] if self.vqgan else y

    def translate_float(self, x: torch.Tensor) -> torch.Tensor:
        """[-1, 1] NHWC fp32 on the device -> the generator's output."""
        with torch.inference_mode(), self._precision():
            return self._apply(x)

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        """``arr`` (n, ...) repeated at its last item to the static batch."""
        n = arr.shape[0]
        if n == 0 or n > self.batch:
            raise ValueError(f"batch {n} out of range for static batch "
                             f"{self.batch}")
        if n < self.batch:
            arr = np.concatenate([arr, np.repeat(arr[-1:], self.batch - n, 0)])
        return np.ascontiguousarray(arr)

    def decode_codes(self, codes: np.ndarray) -> np.ndarray:
        """VQGAN codebook indices (n, h, w) -> uint8 images (n, H, W, 3)
        through the decoder, at the static batch."""
        if not self.vqgan:
            raise ValueError(f"decode_codes needs a vqgan model, this is "
                             f"{self.cfg.model.kind!r}")
        n = codes.shape[0]
        k = self.cfg.model.vq_codebook_size
        if codes.ndim != 3 or codes.min() < 0 or codes.max() >= k:
            raise ValueError(f"codes must be (n, h, w) in [0, {k})")
        codes = self._pad(codes)
        with torch.inference_mode(), self._precision():
            c = torch.from_numpy(codes).to(self.device)
            out = denormalize_to_u8(self.generator.decode_codes(c))
            return out.cpu().numpy()[:n]

    def __call__(self, raw_u8: np.ndarray) -> np.ndarray:
        n = raw_u8.shape[0]
        raw_u8 = self._pad(raw_u8)
        expect = (self.load, self.load, 3)
        if tuple(raw_u8.shape[1:]) != expect or raw_u8.dtype != np.uint8:
            raise ValueError(f"expected uint8 (n, {self.load}, {self.load}, 3), "
                             f"got {raw_u8.dtype} {raw_u8.shape}")
        with torch.inference_mode(), self._precision():
            raw = torch.from_numpy(raw_u8).to(self.device)
            x = center_crop_normalize(raw, self.crop)
            out = denormalize_to_u8(self._apply(x))
            return out.cpu().numpy()[:n]
