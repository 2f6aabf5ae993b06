from uig_torch.models.layers import (InstanceNorm, PadConv, ResnetBlock,
                                     UpsampleConv)
from uig_torch.models.resnet_gen import ResNetGenerator, generator_from_config

__all__ = [
    "InstanceNorm",
    "PadConv",
    "ResNetGenerator",
    "ResnetBlock",
    "UpsampleConv",
    "generator_from_config",
]
