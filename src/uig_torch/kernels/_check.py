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


# The storage types of the kernels (csrc/dtype.cuh): activations and
# weights are fp32 or bf16; statistics, scratch and parameter gradients of
# the norms stay fp32.
FLOAT_TYPES = (torch.float32, torch.bfloat16)


def cuda_operand(name: str, what: str, t: torch.Tensor, shape=None,
                 dtypes=(torch.float32,)) -> None:
    """A CUDA kernel operand: of one of ``dtypes``, contiguous, 16-byte
    aligned, of ``shape``."""
    if t.dtype not in dtypes:
        allowed = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: {what} must be {allowed}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous (NHWC)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be 16-byte aligned")


def storage_type(name: str, what: str, t: torch.Tensor) -> torch.dtype:
    """The kernel's storage type T, read off its first activation operand
    (fp32 or bf16); the wrapper then holds its other T operands to it."""
    cuda_operand(name, what, t, dtypes=FLOAT_TYPES)
    return t.dtype
