"""ResNet-block generator, in PyTorch:

    c7s1-64 -> d128 -> d256 -> R256 x n -> u128 -> u64 -> c7s1-3, tanh

The port of the JAX package's ``models/resnet_gen.py`` for serving and
training. The layer list is the same flat list, so layer ``i`` holds the
parameters of flax's ``layers_{i}`` (the ``"relu"`` and ``"tanh"`` entries,
``BlurPool`` and ``BlurUpsample`` have none), and the feature taps of CUT's
PatchNCE (``with_features``, ``encode_features``) index it as JAX's do.
``resample="strided"`` downsamples with stride-2 convs and upsamples with
``upsample``; ``"antialias"`` (the official CUT generator's) with stride-1
convs followed by ``BlurPool``, and ``BlurUpsample`` followed by a stride-1
conv. The JAX generator's TPU execution knobs (``head_s2d``,
``conv_impl``, ``convin_pallas``, ...) have no counterpart: they compute
the same map, and the port routes by shape. ``dtype`` is the compute dtype
(fp32 or bf16): the input is cast to it, the layers compute in it
(``models/layers.py``), and ReLU and tanh run in it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from uig_torch.models.layers import (BlurPool, BlurUpsample, InstanceNorm,
                                     PadConv, ResnetBlock, UpsampleConv)


class ResNetGenerator(nn.Module):
    def __init__(self, out_channels: int = 3, base_features: int = 64,
                 n_res_blocks: int = 9, norm: str = "instance",
                 pad_mode: str = "reflect", upsample: str = "conv_transpose",
                 resample: str = "strided", in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if resample not in ("strided", "antialias"):
            raise ValueError(f"unknown resample mode {resample!r}")
        if norm != "instance":
            raise NotImplementedError(
                f"norm={norm!r}: the port has instance norm only")
        f, dt = base_features, dtype
        aa = resample == "antialias"
        self.dtype = dt
        kinds: list = [
            PadConv(in_channels, f, 7, pad=3, pad_mode=pad_mode, dtype=dt),
            InstanceNorm(f), "relu",
        ]
        for cin, cout in ((f, 2 * f), (2 * f, 4 * f)):
            if aa:
                kinds += [PadConv(cin, cout, 3, stride=1, pad=1,
                                  pad_mode="zeros", dtype=dt),
                          InstanceNorm(cout), "relu", BlurPool(dtype=dt)]
            else:
                kinds += [PadConv(cin, cout, 3, stride=2, pad=1,
                                  pad_mode="zeros", dtype=dt),
                          InstanceNorm(cout), "relu"]
        kinds += [ResnetBlock(4 * f, norm=norm, pad_mode=pad_mode, dtype=dt)
                  for _ in range(n_res_blocks)]
        for cin, cout in ((4 * f, 2 * f), (2 * f, f)):
            if aa:
                kinds += [BlurUpsample(dtype=dt),
                          PadConv(cin, cout, 3, stride=1, pad=1,
                                  pad_mode="zeros", dtype=dt),
                          InstanceNorm(cout), "relu"]
            else:
                kinds += [UpsampleConv(cin, cout, method=upsample, dtype=dt),
                          InstanceNorm(cout), "relu"]
        kinds += [PadConv(f, out_channels, 7, pad=3, pad_mode=pad_mode,
                          dtype=dt), "tanh"]
        self.kinds = [k if isinstance(k, str) else "module" for k in kinds]
        for i, k in enumerate(kinds):
            if not isinstance(k, str):
                self.add_module(f"layers_{i}", k)

    @property
    def num_layers(self) -> int:
        """The number of entries of the flat layer list: feature taps index
        ``0 .. num_layers - 1``."""
        return len(self.kinds)

    def feature_shapes(self, taps: Sequence[int], height: int, width: int,
                       in_channels: int = 3) -> list[tuple[int, int, int]]:
        """(H, W, C) of the features at ``taps``, in layer order, for an
        input of ``height`` x ``width``, from the layers' shapes alone (no
        forward): convs set C and stride H and W, ``BlurPool`` halves them,
        the upsamples double them."""
        h, w, c = height, width, in_channels
        out = []
        for i, kind in enumerate(self.kinds):
            layer = getattr(self, f"layers_{i}") if kind == "module" else None
            if isinstance(layer, PadConv):
                h, w = ((n + 2 * layer.pad - layer.k) // layer.stride + 1
                        for n in (h, w))
                c = layer.features
            elif isinstance(layer, BlurPool):
                h, w = ((n - 1) // layer.stride + 1 for n in (h, w))
            elif isinstance(layer, (UpsampleConv, BlurUpsample)):
                h, w = 2 * h, 2 * w
                if isinstance(layer, UpsampleConv):
                    c = [p for n, p in layer.named_parameters()
                         if n.endswith("kernel")][-1].shape[-1]
            if i in taps:
                out.append((h, w, c))
        return out

    def _run(self, x: torch.Tensor, taps: Sequence[int] = (),
             last: int | None = None):
        """The layers up to ``last`` (all by default), and the outputs of
        the layers in ``taps``, in layer order. An instance norm runs fused
        with the ReLU after it, except where a tap reads the norm's own
        output: there the norm runs alone and the ReLU after it."""
        x = x.to(self.dtype)
        feats = []
        n = len(self.kinds) if last is None else last + 1
        i = 0
        while i < n:
            kind = self.kinds[i]
            if kind == "relu":
                x = torch.relu(x)
            elif kind == "tanh":
                x = torch.tanh(x)
            else:
                layer = getattr(self, f"layers_{i}")
                if isinstance(layer, InstanceNorm) and i + 1 < n \
                        and self.kinds[i + 1] == "relu" and i not in taps:
                    x = layer(x, relu=True)  # fuse the ReLU that follows
                    i += 1
                else:
                    x = layer(x)
            if i in taps:
                feats.append(x)
            i += 1
        return x, feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, in_channels) in [-1, 1], NHWC; the output is in the
        compute dtype."""
        return self._run(x)[0]

    def with_features(self, x: torch.Tensor, taps: Sequence[int]):
        """The full forward and the features at layer indices ``taps``:
        ``(output, [features in layer order])``."""
        return self._run(x, tuple(taps))

    def encode_features(self, x: torch.Tensor,
                        taps: Sequence[int]) -> list[torch.Tensor]:
        """The features at ``taps`` only: the layers stop at the last tap,
        so the decoder never runs (CUT's NCE passes)."""
        taps = tuple(taps)
        return self._run(x, taps, last=max(taps))[1]
