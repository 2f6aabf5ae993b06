"""Kernel wrappers. Each checks its inputs, launches a hand-written CUDA
kernel for a CUDA tensor (raising if it cannot), keeps a launch count in
``<wrapper>.launches``, and runs its plain PyTorch version only for a CPU
tensor. The CUDA library is built at first launch (``_build``), never at
import."""

from uig_torch.kernels.augment import (center_crop_normalize,
                                       denormalize_to_u8)
from uig_torch.kernels.conv import conv7, conv7_reference
from uig_torch.kernels.convin import conv3_in_act, conv3_in_act_reference
from uig_torch.kernels.norm import instance_norm, instance_norm_reference

KERNELS = (instance_norm, conv3_in_act, conv7)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "center_crop_normalize",
    "conv3_in_act",
    "conv3_in_act_reference",
    "conv7",
    "conv7_reference",
    "denormalize_to_u8",
    "instance_norm",
    "instance_norm_reference",
    "launch_counts",
    "reset_launch_counts",
]
