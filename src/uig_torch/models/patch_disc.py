"""70x70 PatchGAN discriminator, in PyTorch:

    C64 -> C128 -> C256 -> C512 -> 1-channel logit map

The port of the JAX package's ``models/patch_disc.py`` ``PatchDiscriminator``:
4x4 zero-padded convs (library convs), stride 2 on the first ``n_layers``
blocks and then stride 1, instance norm on all but the first block (the
K2f/K2b autograd function), LeakyReLU 0.2. ``norm="none"`` drops the norms
and keeps the biases, as MUNIT's multi-scale D does. Parameters keep flax's
names (``PadConv_i``, ``InstanceNorm_i``) and layouts. Input and output are
NHWC; the output is the (B, h', w', 1) logit map. ``dtype`` is the compute
dtype (fp32 or bf16): the input is cast to it, and the convs, norms and
LeakyReLUs run in it, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from uig_torch.models.layers import InstanceNorm, PadConv


class PatchDiscriminator(nn.Module):
    def __init__(self, base_features: int = 64, n_layers: int = 3,
                 norm: str = "instance", in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers, self.dtype = n_layers, dtype
        # "none" drops normalization; any other value keeps the canonical
        # instance-norm PatchGAN, as in JAX
        self.normed = norm != "none"
        f = base_features
        convs = [PadConv(in_channels, f, 4, stride=2, pad=1, pad_mode="zeros",
                         dtype=dtype)]
        norms = []
        cin = f
        for i in range(1, n_layers + 1):
            cout = f * min(2 ** i, 8)
            stride = 2 if i < n_layers else 1
            convs.append(PadConv(cin, cout, 4, stride=stride, pad=1,
                                 pad_mode="zeros", use_bias=not self.normed,
                                 dtype=dtype))
            if self.normed:
                norms.append(InstanceNorm(cout))
            cin = cout
        convs.append(PadConv(cin, 1, 4, stride=1, pad=1, pad_mode="zeros",
                             dtype=dtype))
        for i, m in enumerate(convs):
            self.add_module(f"PadConv_{i}", m)
        for i, m in enumerate(norms):
            self.add_module(f"InstanceNorm_{i}", m)

    def map_size(self, h: int, w: int) -> tuple[int, int]:
        """Spatial size of the logit map for an (h, w) input."""
        for i in range(self.n_layers + 2):
            s = getattr(self, f"PadConv_{i}").stride
            h, w = (h + 2 - 4) // s + 1, (w + 2 - 4) // s + 1
            if h <= 0 or w <= 0:
                return 0, 0
        return h, w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) NHWC -> logits (B, h', w', 1) in the compute
        dtype."""
        if 0 in self.map_size(x.shape[1], x.shape[2]):
            raise ValueError(
                f"PatchDiscriminator produced an EMPTY logit map for input "
                f"{tuple(x.shape)}: input spatial size is too small for "
                f"n_layers={self.n_layers} (losses over an empty map are "
                "NaN); use a larger image or fewer layers")
        x = F.leaky_relu(self.PadConv_0(x.to(self.dtype)), 0.2)
        for i in range(1, self.n_layers + 1):
            x = getattr(self, f"PadConv_{i}")(x)
            if self.normed:
                x = getattr(self, f"InstanceNorm_{i - 1}")(x)
            x = F.leaky_relu(x, 0.2)
        return getattr(self, f"PadConv_{self.n_layers + 1}")(x)
