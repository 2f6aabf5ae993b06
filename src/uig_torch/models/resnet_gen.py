"""ResNet-block generator, in PyTorch:

    c7s1-64 -> d128 -> d256 -> R256 x n -> u128 -> u64 -> c7s1-3, tanh

The port of the JAX package's ``models/resnet_gen.py`` for serving and
training. The layer list is the same flat list, so layer ``i`` holds the parameters of
flax's ``layers_{i}`` (the ``"relu"`` and ``"tanh"`` entries have none).
Only ``resample="strided"`` is ported. The JAX generator's TPU execution
knobs (``head_s2d``, ``conv_impl``, ``convin_pallas``, ...) have no
counterpart: they compute the same map, and the port routes by shape.
``dtype`` is the compute dtype (fp32 or bf16): the input is cast to it, the
layers compute in it (``models/layers.py``), and ReLU and tanh run in it.
"""

from __future__ import annotations

import torch
from torch import nn

from uig_torch.models.layers import (InstanceNorm, PadConv, ResnetBlock,
                                     UpsampleConv)


class ResNetGenerator(nn.Module):
    def __init__(self, out_channels: int = 3, base_features: int = 64,
                 n_res_blocks: int = 9, norm: str = "instance",
                 pad_mode: str = "reflect", upsample: str = "conv_transpose",
                 resample: str = "strided", in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if resample == "antialias":
            raise NotImplementedError(
                "resample='antialias' (BlurPool/BlurUpsample) is not ported "
                "yet: ROADMAP 'the other ResNet-generator trainers' (CUT)")
        if resample != "strided":
            raise ValueError(f"unknown resample mode {resample!r}")
        if norm != "instance":
            raise NotImplementedError(
                f"norm={norm!r}: the port has instance norm only")
        f, dt = base_features, dtype
        self.dtype = dt
        kinds: list = [
            PadConv(in_channels, f, 7, pad=3, pad_mode=pad_mode, dtype=dt),
            InstanceNorm(f), "relu",
        ]
        for cin, cout in ((f, 2 * f), (2 * f, 4 * f)):
            kinds += [PadConv(cin, cout, 3, stride=2, pad=1, pad_mode="zeros",
                              dtype=dt),
                      InstanceNorm(cout), "relu"]
        kinds += [ResnetBlock(4 * f, norm=norm, pad_mode=pad_mode, dtype=dt)
                  for _ in range(n_res_blocks)]
        for cin, cout in ((4 * f, 2 * f), (2 * f, f)):
            kinds += [UpsampleConv(cin, cout, method=upsample, dtype=dt),
                      InstanceNorm(cout), "relu"]
        kinds += [PadConv(f, out_channels, 7, pad=3, pad_mode=pad_mode,
                          dtype=dt), "tanh"]
        self.kinds = [k if isinstance(k, str) else "module" for k in kinds]
        for i, k in enumerate(kinds):
            if not isinstance(k, str):
                self.add_module(f"layers_{i}", k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, in_channels) in [-1, 1], NHWC; the output is in the
        compute dtype."""
        x = x.to(self.dtype)
        i, n = 0, len(self.kinds)
        while i < n:
            kind = self.kinds[i]
            if kind == "relu":
                x = torch.relu(x)
            elif kind == "tanh":
                x = torch.tanh(x)
            else:
                layer = getattr(self, f"layers_{i}")
                if isinstance(layer, InstanceNorm) and i + 1 < n \
                        and self.kinds[i + 1] == "relu":
                    x = layer(x, relu=True)  # fuse the ReLU that follows
                    i += 1
                else:
                    x = layer(x)
            i += 1
        return x
