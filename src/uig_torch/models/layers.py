"""NHWC building blocks of the ResNet and VQGAN generators, in PyTorch.

The port of the JAX package's ``models/layers.py`` for serving and
training. Activations are NHWC (contiguous) at every public function, as in
JAX.
Parameters keep flax's names and layouts (conv kernels HWIO, instance norm
``scale``/``bias``), so converting a flax tree is a rename
(``uig_torch.convert``). Library convs run on a permuted NCHW view, which is
a channels_last tensor and costs no copy. Every module is differentiable:
the kernels through their autograd functions (``instance_norm_act``,
``conv3_in_act``, ``conv7_act``), reflect padding through
``kernels/reflect.py``, whose adjoint folds the ring in a fixed order.

The JAX execution knobs (``pad_impl``, ``s2d_block``, ``dx_s2d``, ``impl``,
``convin``) are accepted and ignored: every setting computes the same map,
and the port routes by shape instead.

``dtype`` is the compute dtype (fp32 or bf16), with JAX's explicit casts:
the input and the fp32 parameters are cast to it at each op, a library conv
runs in it and its bias is added after it in it (``y + bias.astype(dt)``),
instance norms take fp32 statistics and return their input's dtype, and
the residual skip adds in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from uig_torch.kernels.conv import MAX_COUT, conv7_act, takes_cin
from uig_torch.kernels.conv_s2 import conv3s2_act
from uig_torch.kernels.convin import conv3_in_act
from uig_torch.kernels.norm import instance_norm_act
from uig_torch.kernels.reflect import reflect_pad


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def _add_bias(y: torch.Tensor, bias: torch.Tensor | None,
              dt: torch.dtype) -> torch.Tensor:
    """NHWC ``y + bias.astype(dt)``: the bias added after the conv, in the
    compute dtype, as the JAX layers add it."""
    return y if bias is None else y + bias.to(dt)


class InstanceNorm(nn.Module):
    """Per-example, per-channel normalization over (H, W) with affine
    ``scale``/``bias``: the CUDA kernel of ``kernels/norm.py``. ``relu=True``
    fuses the ReLU that follows it in the generator. fp32 statistics; the
    output has the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return instance_norm_act(x, self.scale, self.bias, self.eps, relu)


class PadConv(nn.Module):
    """Explicitly padded conv (reflect or zeros), stride, bias.

    Routing by shape: a 7x7 stride-1 pad-3 conv with at most 4 output
    channels (the generator head) runs the CUDA kernel of
    ``kernels/conv.py``; a 3x3 stride-2 pad-1 zero-padded conv on an even
    plane with channel counts that are multiples of 4 (the downsamples d128
    and d256) runs the one of ``kernels/conv_s2.py``. Both get the bias
    already cast to the compute dtype, as JAX's Pallas route does, and add
    it in fp32 before their one rounding. Everything else (the 7x7 stem with
    3 input channels, the discriminator's 4x4 convs) runs ``F.conv2d`` in
    the compute dtype, as the JAX package leaves those to XLA."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, pad: int = 0, pad_mode: str = "reflect",
                 use_bias: bool = True, *, pad_impl: str = "fused",
                 s2d_block: int = 0, dx_s2d: int = 0, impl: str = "xla",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pad_mode not in ("reflect", "zeros"):
            raise ValueError(f"unknown padding mode {pad_mode!r}")
        self.in_features = in_features
        self.features, self.k, self.stride, self.pad = (features, kernel,
                                                        stride, pad)
        self.pad_mode = pad_mode
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.randn(kernel, kernel, in_features, features) * 0.02)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def routes_to_conv7(self) -> bool:
        return (self.k == 7 and self.stride == 1 and self.pad == 3
                and self.features <= MAX_COUT
                and takes_cin(self.in_features, self.dtype))

    def routes_to_conv3s2(self, height: int, width: int) -> bool:
        return (self.k == 3 and self.stride == 2 and self.pad == 1
                and self.pad_mode == "zeros" and height % 2 == 0
                and width % 2 == 0 and self.in_features % 4 == 0
                and self.features % 4 == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        w = self.kernel.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if self.routes_to_conv7():
            return conv7_act(x, w, bias, self.pad_mode)
        if self.routes_to_conv3s2(x.shape[1], x.shape[2]):
            return conv3s2_act(x, w, bias)
        w = w.permute(3, 2, 0, 1)
        if self.pad and self.pad_mode == "reflect":
            y = F.conv2d(_nchw(reflect_pad(x, self.pad)), w,
                         stride=self.stride)
        else:
            y = F.conv2d(_nchw(x), w, stride=self.stride, padding=self.pad)
        return _add_bias(_nhwc(y), bias, dt)


class _ConvTransposeParams(nn.Module):
    """flax ``nn.ConvTranspose``'s parameters: kernel (3, 3, in, out), bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn(3, 3, in_features, features) * 0.02)
        self.bias = nn.Parameter(torch.zeros(features))


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of NHWC x, as broadcast and
    reshape (the JAX form): its backward is a sum over each 2x2 window, in
    a fixed order."""
    b, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return y.reshape(b, 2 * h, 2 * w, c)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax's ``padding="SAME"`` along one spatial dim: (low, high) zeros so
    that the output has ceil(size / stride) positions. A 3x3 stride-2 conv
    on an even plane pads (0, 1), not torch's symmetric ``padding=1``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=(s, s))`` with its default
    ``"SAME"`` zero padding: kernel HWIO, bias. A 1x1 stride-1 conv is a
    matmul over channels (XLA's dot in JAX); the others run ``F.conv2d``.
    Both in the compute ``dtype``, with the bias added after them in it."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.stride, self.dtype = kernel, stride, dtype
        self.kernel = nn.Parameter(
            torch.zeros(kernel, kernel, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        b, h, w, c = x.shape
        if self.k == 1 and self.stride == 1:
            y = torch.matmul(x.reshape(-1, c), self.kernel[0, 0].to(dt))
            return _add_bias(y, self.bias, dt).reshape(b, h, w, -1)
        (top, bottom), (left, right) = (same_pads(h, self.k, self.stride),
                                        same_pads(w, self.k, self.stride))
        xc = _nchw(x)
        wt = self.kernel.to(dt).permute(3, 2, 0, 1)
        if top == bottom and left == right:
            y = F.conv2d(xc, wt, stride=self.stride, padding=(top, left))
        else:
            y = F.conv2d(F.pad(xc, (left, right, top, bottom)), wt,
                         stride=self.stride)
        return _add_bias(_nhwc(y), self.bias, dt)


class UpsampleConv(nn.Module):
    """2x upsampling.

    ``conv_transpose``: flax ``ConvTranspose(3, strides=2, padding="SAME")``,
    which is ``F.conv_transpose2d`` of the 180-degree flipped kernel with no
    padding, cropped to the first 2H x 2W. It is NOT torch's
    ``ConvTranspose2d(3, 2, 1, output_padding=1)``.
    ``conv_transpose_torch``: the same VALID transpose cropped by 1 on the
    low edges, which is torch's ``ConvTranspose2d(3, 2, 1,
    output_padding=1)`` on kernels stored pre-flipped (the importer's form).
    ``resize_conv``: nearest 2x, then a zero-padded 3x3 conv.
    All in the compute ``dtype``, the bias added after the conv in it."""

    def __init__(self, in_features: int, features: int,
                 method: str = "conv_transpose",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.method, self.dtype = method, dtype
        if method in ("conv_transpose", "conv_transpose_torch"):
            self.ConvTranspose_0 = _ConvTransposeParams(in_features, features)
        elif method == "resize_conv":
            self.PadConv_0 = PadConv(in_features, features, 3, pad=1,
                                     pad_mode="zeros", dtype=dtype)
        else:
            raise ValueError(f"unknown upsample method {method!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "resize_conv":
            return self.PadConv_0(nearest_up2(x))
        dt = self.dtype
        ct = self.ConvTranspose_0
        w = torch.flip(ct.kernel.to(dt), (0, 1)).permute(2, 3, 0, 1)
        y = F.conv_transpose2d(_nchw(x.to(dt)), w, stride=2)
        h, wd = 2 * x.shape[1], 2 * x.shape[2]
        if self.method == "conv_transpose":
            y = y[:, :, :h, :wd]
        else:
            y = y[:, :, 1:, 1:]
        return _add_bias(_nhwc(y), ct.bias, dt)


def _blur_weight(k: int, c: int, gain: float, device,
                 dtype: torch.dtype) -> torch.Tensor:
    """The depthwise (c, 1, k, k) weight of the normalized binomial filter
    of k taps (row k - 1 of Pascal's triangle, outer product, over its sum)
    times ``gain``, computed in fp32 and cast to ``dtype``."""
    a = torch.ones(1)
    for _ in range(k - 1):
        a = torch.cat([a, torch.zeros(1)]) + torch.cat([torch.zeros(1), a])
    filt = torch.outer(a, a)
    filt = (filt / filt.sum() * gain).to(device, dtype)
    return filt.expand(c, 1, k, k).contiguous()


def _pad_hw(x: torch.Tensor, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Pad the two spatial dims of NHWC ``x`` by ``lo`` before and ``hi``
    after: ``reflect`` (no edge repeat), ``repl`` (the edge repeated) or
    ``zeros``. Slices and concatenation, so the adjoint sums the ring onto
    its sources in a fixed order (PyTorch's reflect and replicate pad
    backwards accumulate with atomics on CUDA)."""
    if mode == "zeros":
        return F.pad(x, (0, 0, lo, hi, lo, hi))
    for dim in (1, 2):
        n = x.shape[dim]
        if mode == "reflect":
            before = x.narrow(dim, 1, lo).flip(dim) if lo else None
            after = x.narrow(dim, n - 1 - hi, hi).flip(dim) if hi else None
        elif mode == "repl":
            edge0, edge1 = x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)
            before = torch.cat([edge0] * lo, dim) if lo else None
            after = torch.cat([edge1] * hi, dim) if hi else None
        else:
            raise ValueError(f"unknown padding mode {mode!r}")
        x = torch.cat([t for t in (before, x, after) if t is not None], dim)
    return x


class BlurPool(nn.Module):
    """Antialiased downsampling (Zhang 2019 blur-pool), the official CUT
    generator's ``Downsample``: the normalized binomial filter of
    ``filt_size`` taps, depthwise, at ``stride``, after padding
    (filt - 1) // 2 before and the rest after in ``pad_mode``. No
    parameters. In the compute ``dtype`` (the filter cast to it), a
    depthwise ``F.conv2d``, as JAX runs it in XLA."""

    def __init__(self, filt_size: int = 3, stride: int = 2,
                 pad_mode: str = "reflect",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.filt_size, self.stride = filt_size, stride
        self.pad_mode, self.dtype = pad_mode, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, k = x.shape[-1], self.filt_size
        w = _blur_weight(k, c, 1.0, x.device, self.dtype)
        lo = (k - 1) // 2
        xp = _pad_hw(x, lo, k - 1 - lo, self.pad_mode).to(self.dtype)
        return _nhwc(F.conv2d(_nchw(xp), w, stride=self.stride, groups=c))


class BlurUpsample(nn.Module):
    """Antialiased 2x upsampling, the official CUT generator's
    ``Upsample``: pad 1 in ``pad_mode`` (``repl`` by default), then the
    depthwise transposed conv with the binomial filter scaled by stride^2
    at stride 2 and padding 1 + (filt - 1) // 2, cropped to exactly 2x
    (torch's ``[1:-1]`` for an even filter, ``[1:]`` for an odd one). No
    parameters. In the compute ``dtype``, a depthwise
    ``F.conv_transpose2d``."""

    def __init__(self, filt_size: int = 4, stride: int = 2,
                 pad_mode: str = "repl", dtype: torch.dtype = torch.float32):
        super().__init__()
        if stride != 2:
            raise NotImplementedError("BlurUpsample supports stride 2")
        if pad_mode not in ("repl", "reflect"):
            raise ValueError(f"unknown padding mode {pad_mode!r}")
        self.filt_size, self.stride = filt_size, stride
        self.pad_mode, self.dtype = pad_mode, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, k = x.shape[-1], self.filt_size
        w = _blur_weight(k, c, self.stride ** 2, x.device, self.dtype)
        xp = _pad_hw(x, 1, 1, self.pad_mode).to(self.dtype)
        y = F.conv_transpose2d(_nchw(xp), w, stride=self.stride,
                               padding=1 + (k - 1) // 2, groups=c)
        y = y[:, :, 1:, 1:] if k % 2 else y[:, :, 1:-1, 1:-1]
        return _nhwc(y)


class ResnetBlock(nn.Module):
    """CycleGAN residual block: [pad1 conv3 IN ReLU pad1 conv3 IN] + skip.
    Each conv+IN(+ReLU) pair is one call of the fused CUDA kernel of
    ``kernels/convin.py``; the parameters keep the unfused composition's
    names (``PadConv_0``, ``InstanceNorm_0``, ``PadConv_1``,
    ``InstanceNorm_1``). The skip adds in the compute ``dtype``."""

    def __init__(self, features: int, norm: str = "instance",
                 pad_mode: str = "reflect", *, pad_impl: str = "fused",
                 convin: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm != "instance":
            raise NotImplementedError(
                f"ResnetBlock norm={norm!r}: the port has instance norm only "
                "(ROADMAP: other families)")
        self.pad_mode, self.dtype = pad_mode, dtype
        self.PadConv_0 = PadConv(features, features, 3, pad=1, pad_mode=pad_mode)
        self.InstanceNorm_0 = InstanceNorm(features)
        self.PadConv_1 = PadConv(features, features, 3, pad=1, pad_mode=pad_mode)
        self.InstanceNorm_1 = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c0, n0, c1, n1 = (self.PadConv_0, self.InstanceNorm_0, self.PadConv_1,
                          self.InstanceNorm_1)
        dt = self.dtype
        x = x.to(dt)
        h = conv3_in_act(x, c0.kernel.to(dt), c0.bias, n0.scale, n0.bias,
                         relu=True, eps=n0.eps, pad_mode=self.pad_mode)
        h = conv3_in_act(h, c1.kernel.to(dt), c1.bias, n1.scale, n1.bias,
                         relu=False, eps=n1.eps, pad_mode=self.pad_mode)
        return x + h
