"""NHWC building blocks of the ResNet generator, in PyTorch.

The port of the JAX package's ``models/layers.py`` for the serving path.
Activations are NHWC (contiguous) at every public function, as in JAX.
Parameters keep flax's names and layouts (conv kernels HWIO, instance norm
``scale``/``bias``), so converting a flax tree is a rename
(``uig_torch.convert``). Library convs run on a permuted NCHW view, which is
a channels_last tensor and costs no copy.

The JAX execution knobs (``pad_impl``, ``s2d_block``, ``dx_s2d``, ``impl``,
``convin``) are accepted and ignored: every setting computes the same map,
and the port routes by shape instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from uig_torch.kernels.conv import MAX_COUT, conv7
from uig_torch.kernels.convin import conv3_in_act
from uig_torch.kernels.norm import instance_norm


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


class InstanceNorm(nn.Module):
    """Per-example, per-channel normalization over (H, W) with affine
    ``scale``/``bias``: the CUDA kernel of ``kernels/norm.py``. ``relu=True``
    fuses the ReLU that follows it in the generator."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return instance_norm(x, self.scale, self.bias, self.eps, relu)


class PadConv(nn.Module):
    """Explicitly padded conv (reflect or zeros), stride, bias.

    Routing: a 7x7 stride-1 pad-3 conv with at most 4 output channels (the
    generator head) runs the CUDA kernel of ``kernels/conv.py``. Everything
    else (the 7x7 stem with 3 input channels, the stride-2 downsamples) runs
    ``F.conv2d``, as the JAX package leaves those to XLA."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, pad: int = 0, pad_mode: str = "reflect",
                 use_bias: bool = True, *, pad_impl: str = "fused",
                 s2d_block: int = 0, dx_s2d: int = 0, impl: str = "xla"):
        super().__init__()
        if pad_mode not in ("reflect", "zeros"):
            raise ValueError(f"unknown padding mode {pad_mode!r}")
        self.features, self.k, self.stride, self.pad = (features, kernel,
                                                        stride, pad)
        self.pad_mode = pad_mode
        self.kernel = nn.Parameter(
            torch.randn(kernel, kernel, in_features, features) * 0.02)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def routes_to_conv7(self) -> bool:
        return (self.k == 7 and self.stride == 1 and self.pad == 3
                and self.features <= MAX_COUT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.routes_to_conv7():
            return conv7(x, self.kernel, self.bias, self.pad_mode)
        xn = _nchw(x)
        w = self.kernel.permute(3, 2, 0, 1)
        if self.pad and self.pad_mode == "reflect":
            p = self.pad
            y = F.conv2d(F.pad(xn, (p, p, p, p), mode="reflect"), w, self.bias,
                         stride=self.stride)
        else:
            y = F.conv2d(xn, w, self.bias, stride=self.stride,
                         padding=self.pad)
        return _nhwc(y)


class _ConvTransposeParams(nn.Module):
    """flax ``nn.ConvTranspose``'s parameters: kernel (3, 3, in, out), bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn(3, 3, in_features, features) * 0.02)
        self.bias = nn.Parameter(torch.zeros(features))


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of NHWC x."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class UpsampleConv(nn.Module):
    """2x upsampling.

    ``conv_transpose``: flax ``ConvTranspose(3, strides=2, padding="SAME")``,
    which is ``F.conv_transpose2d`` of the 180-degree flipped kernel with no
    padding, cropped to the first 2H x 2W. It is NOT torch's
    ``ConvTranspose2d(3, 2, 1, output_padding=1)``.
    ``conv_transpose_torch``: the same VALID transpose cropped by 1 on the
    low edges, which is torch's ``ConvTranspose2d(3, 2, 1,
    output_padding=1)`` on kernels stored pre-flipped (the importer's form).
    ``resize_conv``: nearest 2x, then a zero-padded 3x3 conv."""

    def __init__(self, in_features: int, features: int,
                 method: str = "conv_transpose"):
        super().__init__()
        self.method = method
        if method in ("conv_transpose", "conv_transpose_torch"):
            self.ConvTranspose_0 = _ConvTransposeParams(in_features, features)
        elif method == "resize_conv":
            self.PadConv_0 = PadConv(in_features, features, 3, pad=1,
                                     pad_mode="zeros")
        else:
            raise ValueError(f"unknown upsample method {method!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "resize_conv":
            return self.PadConv_0(nearest_up2(x))
        ct = self.ConvTranspose_0
        w = torch.flip(ct.kernel, (0, 1)).permute(2, 3, 0, 1)
        y = F.conv_transpose2d(_nchw(x), w, ct.bias, stride=2)
        h, wd = 2 * x.shape[1], 2 * x.shape[2]
        if self.method == "conv_transpose":
            y = y[:, :, :h, :wd]
        else:
            y = y[:, :, 1:, 1:]
        return _nhwc(y)


class ResnetBlock(nn.Module):
    """CycleGAN residual block: [pad1 conv3 IN ReLU pad1 conv3 IN] + skip.
    Each conv+IN(+ReLU) pair is one call of the fused CUDA kernel of
    ``kernels/convin.py``; the parameters keep the unfused composition's
    names (``PadConv_0``, ``InstanceNorm_0``, ``PadConv_1``,
    ``InstanceNorm_1``)."""

    def __init__(self, features: int, norm: str = "instance",
                 pad_mode: str = "reflect", *, pad_impl: str = "fused",
                 convin: bool = False):
        super().__init__()
        if norm != "instance":
            raise NotImplementedError(
                f"ResnetBlock norm={norm!r}: the port has instance norm only "
                "(ROADMAP: other families)")
        self.pad_mode = pad_mode
        self.PadConv_0 = PadConv(features, features, 3, pad=1, pad_mode=pad_mode)
        self.InstanceNorm_0 = InstanceNorm(features)
        self.PadConv_1 = PadConv(features, features, 3, pad=1, pad_mode=pad_mode)
        self.InstanceNorm_1 = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c0, n0, c1, n1 = (self.PadConv_0, self.InstanceNorm_0, self.PadConv_1,
                          self.InstanceNorm_1)
        h = conv3_in_act(x, c0.kernel, c0.bias, n0.scale, n0.bias, relu=True,
                         eps=n0.eps, pad_mode=self.pad_mode)
        h = conv3_in_act(h, c1.kernel, c1.bias, n1.scale, n1.bias, relu=False,
                         eps=n1.eps, pad_mode=self.pad_mode)
        return x + h
