"""Input checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version), False when
    all lie on one CUDA device (kernel); raises on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def cuda_operand(name: str, what: str, t: torch.Tensor, shape=None) -> None:
    """A CUDA kernel operand: fp32, contiguous, 16-byte aligned, of ``shape``."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous (NHWC)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be 16-byte aligned")
