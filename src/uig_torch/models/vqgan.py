"""VQGAN generator, in PyTorch: the port of the JAX package's
``models/vqgan.py``.

Encoder: 3x3 conv stem, a ladder of residual blocks with a stride-2
downsample between stages and self-attention at the configured
resolutions, a middle (block, attention, block), then GroupNorm, swish and a
1x1 conv to the embedding. ``VectorQuantizer``: nearest codeword by one
(BHW, K) distance matmul, the straight-through estimator, codebook and
commitment losses and the codebook perplexity. The decoder mirrors the
encoder with nearest 2x upsampling and ends in a tanh.

Activations are NHWC in the compute ``dtype``, fp32 or bf16, with the JAX
modules' explicit casts: the encoder and decoder cast their input to it;
convs, GroupNorm, swish, the attention, nearest-up, the residual adds and
tanh run in it; the quantizer computes in fp32 and returns its
straight-through output in its input's dtype. Parameters are fp32 in both.
They keep flax's auto-names and layouts
(``encoder.VQResBlock_3.GN_1.GroupNorm_0.scale``, ``quantizer.codebook``,
conv kernels HWIO), so converting a flax tree is a rename. Convs are
``layers.Conv`` (flax's "SAME" padding); the attention is the K5f/K5b
autograd function of ``kernels/attention.py``; GroupNorm mirrors flax's
arithmetic (``group_norm``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from uig_torch.kernels.attention import attention
from uig_torch.models.layers import Conv, nearest_up2

GN_EPS = 1e-6


def _sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """sigmoid as XLA expands ``logistic`` in bf16: 1 / (1 + exp(-x)), each
    of the four ops rounded to bf16."""
    return torch.reciprocal(1.0 + torch.exp(-x))


class _SwishBF16(torch.autograd.Function):
    """x sigmoid(x) in bf16, keeping only x for the backward, which
    recomputes the sigmoid with the forward's roundings and then takes
    JAX's VJP of ``x * jax.nn.sigmoid(x)`` op by op, each rounded to bf16:
    dx = dy s + (x dy)(s (1 - s))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * _sigmoid_bf16(x)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        s = _sigmoid_bf16(x)
        return dy * s + (x * dy) * (s * (1.0 - s))


def _swish(x: torch.Tensor) -> torch.Tensor:
    """x sigmoid(x): ``F.silu`` in fp32; in bf16 as JAX rounds it
    (``_SwishBF16``)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return _SwishBF16.apply(x)


def _gn_moments(xg: torch.Tensor, eps: float):
    """flax's fast variance over a (B, HW, G, C/G) view: E[x^2] - E[x]^2,
    clipped at 0, in fp32; returns (mean, 1 / sqrt(var + eps))."""
    mean = xg.mean(dim=(1, 3), keepdim=True)
    mean2 = xg.square().mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


class _GroupNorm(torch.autograd.Function):
    """Forward in flax's order, y = (x - mean) * (rstd * scale) + bias, in
    fp32 from x widened, rounded once to x's dtype; the backward by the
    closed form in fp32, keeping only x (in its own dtype) and the (B, G)
    moments. dscale and dbias are fp32; dx has x's dtype, and in bf16 it
    is rounded as JAX's VJP of flax's GroupNorm rounds it (``backward``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        b, h, w, c = x.shape
        xg = x.reshape(b, h * w, groups, c // groups).to(torch.float32)
        mean, rstd = _gn_moments(xg, eps)
        sg = scale.reshape(groups, c // groups)
        y = (xg - mean) * (rstd * sg) + bias.reshape(groups, c // groups)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.groups = groups
        return y.reshape(b, h, w, c).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        b, h, w, c = x.shape
        shape = (b, h * w, ctx.groups, c // ctx.groups)
        xhat = (x.reshape(shape).to(torch.float32) - mean) * rstd
        dyg = dy.reshape(shape).to(torch.float32)
        g = dyg * scale.reshape(shape[2:])
        if x.dtype == torch.float32:
            dx = rstd * (g - g.mean(dim=(1, 3), keepdim=True)
                         - xhat * (g * xhat).mean(dim=(1, 3), keepdim=True))
        else:
            # JAX's cotangent of x sums its two uses in x's dtype: the
            # direct path g rstd and the statistics' path, each rounded
            # once, then added (and rounded) in bf16
            stats = -rstd * (g.mean(dim=(1, 3), keepdim=True)
                             + xhat * (g * xhat).mean(dim=(1, 3), keepdim=True))
            dx = (g * rstd).to(x.dtype) + stats.to(x.dtype)
        dscale = (dyg * xhat).sum(dim=(0, 1)).reshape(c)
        dbias = dyg.sum(dim=(0, 1)).reshape(c)
        return dx.reshape(b, h, w, c).to(x.dtype), dscale, dbias, None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = GN_EPS) -> torch.Tensor:
    """flax ``nn.GroupNorm(dtype=x.dtype, param_dtype=float32)`` over NHWC
    x: contiguous channel groups, fp32 statistics over (H, W, C / groups),
    the output in x's dtype."""
    return _GroupNorm.apply(x.contiguous(), scale, bias, groups, eps)


class _GroupNormParams(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


class GN(nn.Module):
    """The JAX ``GN``: ``nn.GroupNorm(min(32, C), epsilon=1e-6,
    dtype=dtype)``, on x already in ``dtype`` (the ladder's compute
    dtype)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups, self.dtype = min(32, features), dtype
        self.GroupNorm_0 = _GroupNormParams(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.dtype:
            raise TypeError(f"GN in {self.dtype} given {x.dtype}")
        p = self.GroupNorm_0
        return group_norm(x, p.scale, p.bias, self.groups)


class VQResBlock(nn.Module):
    """[GN swish conv3 GN swish conv3] + skip (a 1x1 conv when the width
    changes)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.GN_0 = GN(in_features, dtype)
        self.Conv_0 = Conv(in_features, features, 3, dtype=dtype)
        self.GN_1 = GN(features, dtype)
        self.Conv_1 = Conv(features, features, 3, dtype=dtype)
        if in_features != features:
            self.Conv_2 = Conv(in_features, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(_swish(self.GN_0(x)))
        h = self.Conv_1(_swish(self.GN_1(h)))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class AttnBlock(nn.Module):
    """x + proj(attention(q, k, v)) over the h*w tokens, single head at the
    full width C; q, k, v and proj are 1x1 convs of GN(x)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.GN_0 = GN(features, dtype)
        for i in range(4):
            self.add_module(f"Conv_{i}", Conv(features, features, 1,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.GN_0(x)
        q, k, v = (getattr(self, f"Conv_{i}")(y).reshape(b, h * w, c)
                   for i in range(3))
        o = attention(q, k, v).reshape(b, h, w, c)
        return x + self.Conv_3(o)


class _Ladder(nn.Module):
    """A module list under flax's auto-names (``Conv_0``, ``VQResBlock_2``,
    ...) and the plan that applies it: module names, and ``"swish"``,
    ``"up"`` (nearest 2x) or ``"tanh"`` between them, all in ``dtype``,
    which the input is cast to."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self._counts: dict = {}
        self.plan: list[str] = []

    def _add(self, module: nn.Module) -> None:
        kind = type(module).__name__
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        self.plan.append(f"{kind}_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        for step in self.plan:
            if step == "swish":
                h = _swish(h)
            elif step == "up":
                h = nearest_up2(h)
            elif step == "tanh":
                h = torch.tanh(h)
            else:
                h = getattr(self, step)(h)
        return h


class VQGANEncoder(_Ladder):
    def __init__(self, base_features: int = 128,
                 channel_mults: tuple[int, ...] = (1, 1, 2, 2, 4),
                 embed_dim: int = 256, attn_resolutions: tuple[int, ...] = (32,),
                 resolution: int = 512, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        dt = dtype
        self._add(Conv(in_channels, base_features, 3, dtype=dt))
        h, res = base_features, resolution
        for i, mult in enumerate(channel_mults):
            f = base_features * mult
            self._add(VQResBlock(h, f, dt))
            self._add(VQResBlock(f, f, dt))
            h = f
            if res in attn_resolutions:
                self._add(AttnBlock(f, dt))
            if i < len(channel_mults) - 1:  # downsample between stages
                self._add(Conv(f, f, 3, stride=2, dtype=dt))
                res = -(-res // 2)
        self._add(VQResBlock(h, h, dt))
        self._add(AttnBlock(h, dt))
        self._add(VQResBlock(h, h, dt))
        self._add(GN(h, dt))
        self.plan.append("swish")
        self._add(Conv(h, embed_dim, 1, dtype=dt))
        self.latent_resolution = res


class VQGANDecoder(_Ladder):
    def __init__(self, base_features: int = 128,
                 channel_mults: tuple[int, ...] = (1, 1, 2, 2, 4),
                 out_channels: int = 3, attn_resolutions: tuple[int, ...] = (32,),
                 latent_resolution: int = 32, embed_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        dt = dtype
        f = base_features * channel_mults[-1]
        self._add(Conv(embed_dim, f, 3, dtype=dt))
        self._add(VQResBlock(f, f, dt))
        self._add(AttnBlock(f, dt))
        self._add(VQResBlock(f, f, dt))
        h, res = f, latent_resolution
        for i, mult in reversed(list(enumerate(channel_mults))):
            f = base_features * mult
            self._add(VQResBlock(h, f, dt))
            self._add(VQResBlock(f, f, dt))
            h = f
            if res in attn_resolutions:
                self._add(AttnBlock(f, dt))
            if i > 0:  # upsample between stages
                self.plan.append("up")
                self._add(Conv(f, f, 3, dtype=dt))
                res *= 2
        self._add(GN(h, dt))
        self.plan.append("swish")
        self._add(Conv(h, out_channels, 3, dtype=dt))
        self.plan.append("tanh")


class VQOutput(NamedTuple):
    quantized: torch.Tensor  # (B, h, w, D) straight-through
    codebook_loss: torch.Tensor  # ()
    commitment_loss: torch.Tensor  # ()
    codes: torch.Tensor  # (B, h, w) int32
    perplexity: torch.Tensor  # () codebook usage


class VectorQuantizer(nn.Module):
    def __init__(self, codebook_size: int = 1024, embed_dim: int = 256):
        super().__init__()
        self.codebook_size, self.embed_dim = codebook_size, embed_dim
        self.codebook = nn.Parameter(torch.zeros(codebook_size, embed_dim))
        self.pinned: torch.Tensor | None = None  # see pin_codes

    def embed(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (...) -> (..., D) codebook vectors."""
        return self.codebook[codes.long()]

    def forward(self, z: torch.Tensor) -> VQOutput:
        cb = self.codebook
        z32 = z.to(torch.float32)
        flat = z32.reshape(-1, self.embed_dim)
        # argmin_k |z - e_k|^2 by one (BHW, K) matmul; ties take the first
        if self.pinned is None:
            d = ((flat ** 2).sum(1, keepdim=True) - 2.0 * flat @ cb.T
                 + (cb ** 2).sum(1)[None, :])
            codes = torch.argmin(d, dim=1)
        else:
            codes = self.pinned.reshape(-1).to(flat.device, torch.int64)
        # the gather as a one-hot product: exact in fp32, and its backward
        # (one_hot^T @ g) sums each codeword's gradient in a fixed order
        onehot = F.one_hot(codes, self.codebook_size).to(torch.float32)
        quant = (onehot @ cb).reshape(z32.shape)
        codebook_loss = torch.mean(torch.square(z32.detach() - quant))
        commitment = torch.mean(torch.square(z32 - quant.detach()))
        quant_st = z32 + (quant - z32).detach()
        counts = torch.bincount(codes, minlength=self.codebook_size)
        p = counts.to(torch.float32) / codes.numel()
        perplexity = torch.exp(-torch.sum(p * torch.log(p + 1e-10)))
        return VQOutput(quant_st.to(z.dtype), codebook_loss, commitment,
                        codes.reshape(z.shape[:-1]).to(torch.int32),
                        perplexity)


@contextlib.contextmanager
def pin_codes(quantizer: VectorQuantizer, codes):
    """Within the block, ``quantizer`` gives its latents ``codes`` (B, h, w)
    in place of their nearest codewords. Two implementations whose encoders
    round apart pick other codes for the latents that lie within rounding
    of two codewords; pinned to one choice, the rest of their steps can be
    compared."""
    quantizer.pinned = torch.as_tensor(codes)
    try:
        yield
    finally:
        quantizer.pinned = None


class VQGANGenerator(nn.Module):
    """Encoder + VectorQuantizer + Decoder. ``forward(x)`` gives
    ``(reconstruction, VQOutput)``, the reconstruction in ``dtype``;
    ``decode_codes`` is the latent-space sampling path."""

    def __init__(self, base_features: int = 128,
                 channel_mults: tuple[int, ...] = (1, 1, 2, 2, 4),
                 embed_dim: int = 256, codebook_size: int = 1024,
                 out_channels: int = 3, attn_resolutions: tuple[int, ...] = (32,),
                 resolution: int = 512, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = VQGANEncoder(base_features, channel_mults, embed_dim,
                                    attn_resolutions, resolution, in_channels,
                                    dtype)
        self.decoder = VQGANDecoder(base_features, channel_mults, out_channels,
                                    attn_resolutions,
                                    self.encoder.latent_resolution, embed_dim,
                                    dtype)
        self.quantizer = VectorQuantizer(codebook_size, embed_dim)

    def forward(self, x: torch.Tensor):
        vq = self.encode(x)
        return self.decoder(vq.quantized), vq

    def encode(self, x: torch.Tensor) -> VQOutput:
        return self.quantizer(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, h, w) -> images (B, H, W, out_channels) in [-1, 1]."""
        return self.decoder(self.quantizer.embed(codes))
