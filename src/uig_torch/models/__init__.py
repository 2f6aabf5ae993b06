from uig_torch.models.layers import (InstanceNorm, PadConv, ResnetBlock,
                                     UpsampleConv)
from uig_torch.models.patch_disc import PatchDiscriminator
from uig_torch.models.resnet_gen import (ResNetGenerator, check_float32,
                                         generator_from_config)

__all__ = [
    "InstanceNorm",
    "PadConv",
    "PatchDiscriminator",
    "ResNetGenerator",
    "ResnetBlock",
    "UpsampleConv",
    "check_float32",
    "generator_from_config",
]
