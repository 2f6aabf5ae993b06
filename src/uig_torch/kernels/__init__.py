"""Kernel wrappers. Each checks its inputs, launches a hand-written CUDA
kernel for a CUDA tensor (raising if it cannot), keeps a launch count in
``<wrapper>.launches``, and runs its plain PyTorch version only for a CPU
tensor. The CUDA library is built at first launch (``_build``), never at
import. ``instance_norm_act``, ``conv3_in_act``, ``conv7_act`` and
``conv3s2_act`` are the differentiable forms the ResNet models call;
``attention`` the one the VQGAN attention block calls. ``conv_core`` (the
generic VALID conv, on no model's path) counts its launches apart from
``KERNELS``."""

from uig_torch.kernels.attention import (attention, attention_bwd,
                                         attention_bwd_reference,
                                         attention_fwd, attention_reference)
from uig_torch.kernels.augment import (augment_batch, augment_batch_reference,
                                       center_crop_normalize,
                                       denormalize_to_u8, draw_augment)
from uig_torch.kernels.conv import (conv7, conv7_act, conv7_dgrad,
                                    conv7_dgrad_reference, conv7_reference,
                                    conv7_wgrad, conv7_wgrad_reference)
from uig_torch.kernels.conv_s2 import (conv3s2, conv3s2_act, conv3s2_dgrad,
                                       conv3s2_dgrad_reference,
                                       conv3s2_reference, conv3s2_wgrad,
                                       conv3s2_wgrad_reference, conv_core,
                                       conv_core_reference)
from uig_torch.kernels.convin import conv3_in_act, conv3_in_act_reference
from uig_torch.kernels.norm import (instance_norm, instance_norm_act,
                                    instance_norm_bwd,
                                    instance_norm_bwd_reference,
                                    instance_norm_reference)

KERNELS = (augment_batch, instance_norm, instance_norm_bwd, conv3_in_act,
           conv7, conv7_dgrad, conv7_wgrad, conv3s2, conv3s2_dgrad,
           conv3s2_wgrad, attention_fwd, attention_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "attention",
    "attention_bwd",
    "attention_bwd_reference",
    "attention_fwd",
    "attention_reference",
    "augment_batch",
    "augment_batch_reference",
    "center_crop_normalize",
    "conv3_in_act",
    "conv3_in_act_reference",
    "conv3s2",
    "conv3s2_act",
    "conv3s2_dgrad",
    "conv3s2_dgrad_reference",
    "conv3s2_reference",
    "conv3s2_wgrad",
    "conv3s2_wgrad_reference",
    "conv7",
    "conv7_act",
    "conv7_dgrad",
    "conv7_dgrad_reference",
    "conv7_reference",
    "conv7_wgrad",
    "conv7_wgrad_reference",
    "conv_core",
    "conv_core_reference",
    "denormalize_to_u8",
    "draw_augment",
    "instance_norm",
    "instance_norm_act",
    "instance_norm_bwd",
    "instance_norm_bwd_reference",
    "instance_norm_reference",
    "launch_counts",
    "reset_launch_counts",
]
