"""InceptionV3 (the FID variant), in PyTorch: the port of the JAX package's
``eval/inception.py``, the feature extractor of ``eval/fid.py``.

The canonical FID-Inception topology: pool3, 2048-d features, 299x299
input; BatchNorm in inference mode (``(x - mean) * (rsqrt(var + 1e-3) *
scale) + bias``, flax's order), average pools that exclude padding
(``count_include_pad=False``) and a max pool in Mixed_7c; the optional
``fc`` head gives class logits for the Inception Score. The modules keep
flax's names (``Conv2d_1a_3x3.conv.kernel``, ``Mixed_5b.b1x1.bn.scale``,
...), conv kernels HWIO, so a flax ``.npz`` loads by a rename: parameters
under ``params/``, the BatchNorm statistics under ``batch_stats/``. The
convs are library convs; ``eval/fid.py`` runs them under
``serving.exact_fp32``. JAX leaves them to XLA: none is a Pallas kernel.

``init_inception``'s ``apply_fn`` resizes any other input size to 299² as
``jax.image.resize(..., "bilinear")`` does: a triangle kernel, widened to
antialias when it shrinks, its weights renormalized at the edges. The
weights of each axis are computed in numpy float32 as
``jax/_src/image/scale.py`` computes them, and applied as two matmuls.

Without a weights file the network is drawn from seed 0 with numpy by
flax's default initializers (lecun-normal kernels, BatchNorm scale 1, bias
0, mean 0, variance 1): it differs from the JAX package's seed-0 network.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from uig_torch.convert import seeded_flax
from uig_torch.eval.fid import conv_hwio
from uig_torch.runtime import resolve_device

SIZE = 299
BN_EPS = 1e-3


class BasicConv(nn.Module):
    """Conv (no bias) + BatchNorm in inference mode + ReLU; NCHW."""

    def __init__(self, cin: int, cout: int, kernel, strides=(1, 1),
                 padding: str = "SAME"):
        super().__init__()
        self.conv = nn.Module()
        self.conv.kernel = nn.Parameter(torch.zeros(*kernel, cin, cout))
        self.bn = nn.Module()
        self.bn.scale = nn.Parameter(torch.ones(cout))
        self.bn.bias = nn.Parameter(torch.zeros(cout))
        self.bn.register_buffer("mean", torch.zeros(cout))
        self.bn.register_buffer("var", torch.ones(cout))
        self.strides, self.padding = tuple(strides), padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_hwio(x, self.conv.kernel, None, self.strides, self.padding)
        bn = self.bn
        mul = torch.rsqrt(bn.var + BN_EPS) * bn.scale
        y = (x - bn.mean[:, None, None]) * mul[:, None, None] \
            + bn.bias[:, None, None]
        return torch.relu(y)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.b1x1 = BasicConv(cin, 64, (1, 1))
        self.b5x5_1 = BasicConv(cin, 48, (1, 1))
        self.b5x5_2 = BasicConv(48, 64, (5, 5))
        self.b3x3dbl_1 = BasicConv(cin, 64, (1, 1))
        self.b3x3dbl_2 = BasicConv(64, 96, (3, 3))
        self.b3x3dbl_3 = BasicConv(96, 96, (3, 3))
        self.bpool = BasicConv(cin, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.b1x1(x)
        b5 = self.b5x5_2(self.b5x5_1(x))
        b3 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        bp = self.bpool(_avg_pool(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b3x3 = BasicConv(cin, 384, (3, 3), (2, 2), "VALID")
        self.b3x3dbl_1 = BasicConv(cin, 64, (1, 1))
        self.b3x3dbl_2 = BasicConv(64, 96, (3, 3))
        self.b3x3dbl_3 = BasicConv(96, 96, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        b3 = self.b3x3(x)
        bd = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.b1x1 = BasicConv(cin, 192, (1, 1))
        self.b7x7_1 = BasicConv(cin, c7, (1, 1))
        self.b7x7_2 = BasicConv(c7, c7, (1, 7))
        self.b7x7_3 = BasicConv(c7, 192, (7, 1))
        self.b7x7dbl_1 = BasicConv(cin, c7, (1, 1))
        self.b7x7dbl_2 = BasicConv(c7, c7, (7, 1))
        self.b7x7dbl_3 = BasicConv(c7, c7, (1, 7))
        self.b7x7dbl_4 = BasicConv(c7, c7, (7, 1))
        self.b7x7dbl_5 = BasicConv(c7, 192, (1, 7))
        self.bpool = BasicConv(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.b1x1(x)
        b7 = self.b7x7_3(self.b7x7_2(self.b7x7_1(x)))
        bd = self.b7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"b7x7dbl_{i}")(bd)
        bp = self.bpool(_avg_pool(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b3x3_1 = BasicConv(cin, 192, (1, 1))
        self.b3x3_2 = BasicConv(192, 320, (3, 3), (2, 2), "VALID")
        self.b7x7x3_1 = BasicConv(cin, 192, (1, 1))
        self.b7x7x3_2 = BasicConv(192, 192, (1, 7))
        self.b7x7x3_3 = BasicConv(192, 192, (7, 1))
        self.b7x7x3_4 = BasicConv(192, 192, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        b3 = self.b3x3_2(self.b3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"b7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.b1x1 = BasicConv(cin, 320, (1, 1))
        self.b3x3_1 = BasicConv(cin, 384, (1, 1))
        self.b3x3_2a = BasicConv(384, 384, (1, 3))
        self.b3x3_2b = BasicConv(384, 384, (3, 1))
        self.b3x3dbl_1 = BasicConv(cin, 448, (1, 1))
        self.b3x3dbl_2 = BasicConv(448, 384, (3, 3))
        self.b3x3dbl_3a = BasicConv(384, 384, (1, 3))
        self.b3x3dbl_3b = BasicConv(384, 384, (3, 1))
        self.bpool = BasicConv(cin, 192, (1, 1))
        self.pool = pool

    def forward(self, x):
        b1 = self.b1x1(x)
        b3 = self.b3x3_1(x)
        b3 = torch.cat([self.b3x3_2a(b3), self.b3x3_2b(b3)], 1)
        bd = self.b3x3dbl_2(self.b3x3dbl_1(x))
        bd = torch.cat([self.b3x3dbl_3a(bd), self.b3x3dbl_3b(bd)], 1)
        bp = (F.max_pool2d(x, 3, 1, 1) if self.pool == "max"
              else _avg_pool(x))
        return torch.cat([b1, b3, bd, self.bpool(bp)], 1)


class InceptionV3Features(nn.Module):
    """Input: (B, H, W, 3) NHWC in [-1, 1], H and W at least 75 (299 for
    the published features). Output: (B, 2048) pool3 features, or (B,
    num_classes) logits when ``num_classes`` > 0 (the fc head of the
    Inception Score)."""

    def __init__(self, num_classes: int = 0):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, (3, 3), (2, 2), "VALID")
        self.Conv2d_2a_3x3 = BasicConv(32, 32, (3, 3), padding="VALID")
        self.Conv2d_2b_3x3 = BasicConv(32, 64, (3, 3))
        self.Conv2d_3b_1x1 = BasicConv(64, 80, (1, 1), padding="VALID")
        self.Conv2d_4a_3x3 = BasicConv(80, 192, (3, 3), padding="VALID")
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool="max")
        self.num_classes = num_classes
        if num_classes:
            self.fc = nn.Module()
            self.fc.kernel = nn.Parameter(torch.zeros(2048, num_classes))
            self.fc.bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_s2(x)
        x = _max_pool_s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a",
                     "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        x = x.mean((2, 3))  # global average pool -> (B, 2048)
        if self.num_classes:
            x = x @ self.fc.kernel + self.fc.bias
        return x


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s
    bilinear (triangle) kernel along one axis, antialiased when it shrinks:
    ``compute_weight_mat`` of ``jax/_src/image/scale.py`` in float32."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0) * f32(inv_scale) - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC ``x`` -> (B, h, w, C) fp32, as ``jax.image.resize(x, (B, h, w,
    C), "bilinear")``: the height and the width weights applied as two
    matmuls."""
    x = x.to(torch.float32)
    wh = torch.from_numpy(resize_weights(x.shape[1], h)).to(x.device)
    ww = torch.from_numpy(resize_weights(x.shape[2], w)).to(x.device)
    y = torch.einsum("bhwc,hi->biwc", x, wh)
    return torch.einsum("biwc,wj->bijc", y, ww)


def inception_state_from_flax(flat: dict, model: InceptionV3Features
                              ) -> dict[str, torch.Tensor]:
    """The model's state dict from flax's flat keys (``params/...`` and
    ``batch_stats/...``); raises KeyError naming the first key the file
    lacks (as the JAX loader does; keys the model does not use are
    ignored) and ValueError on a shape that differs."""
    state = {}
    for name, ref in model.state_dict().items():
        section = "batch_stats/" if name.endswith((".mean", ".var")) \
            else "params/"
        key = section + name.replace(".", "/")
        if key not in flat:
            raise KeyError(f"weights file missing param {key}")
        t = torch.from_numpy(np.array(flat[key], dtype=np.float32))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: weights have shape {tuple(t.shape)}, "
                             f"the model wants {tuple(ref.shape)}")
        state[name] = t
    return state


def seeded_inception_flax(num_classes: int = 0, seed: int = 0) -> dict:
    """Flat flax weights of ``InceptionV3Features`` drawn with numpy from
    ``seed`` by flax's default initializers (``convert.seeded_flax``), with
    BatchNorm statistics mean 0 and variance 1; drawn once a process."""
    return dict(_seeded_inception_flax(num_classes, seed))


@functools.lru_cache(maxsize=2)
def _seeded_inception_flax(num_classes: int, seed: int) -> dict:
    model = InceptionV3Features(num_classes)
    flat = seeded_flax(model, seed)
    for name, buf in model.named_buffers():
        flat["batch_stats/" + name.replace(".", "/")] = (
            np.zeros if name.endswith(".mean") else np.ones)(
                tuple(buf.shape), np.float32)
    return flat


def init_inception(weights_path: str | None = None, num_classes: int = 0,
                   device="cuda"):
    """(apply_fn, model) on ``device``: the weights from a flat flax
    ``.npz`` (``a/b/c`` keys), or drawn from seed 0.
    ``apply_fn(model, imgs)`` takes NHWC images in [-1, 1] and resizes
    them to 299² first unless they are 299²."""
    model = InceptionV3Features(num_classes)
    if weights_path:
        with np.load(weights_path) as z:
            flat = {k: z[k] for k in z.files}
    else:
        flat = seeded_inception_flax(num_classes)
    model.load_state_dict(inception_state_from_flax(flat, model))
    model = model.to(resolve_device(device)).eval().requires_grad_(False)

    def apply_fn(m, imgs):
        if tuple(imgs.shape[1:3]) != (SIZE, SIZE):
            imgs = resize_bilinear(imgs, SIZE, SIZE)
        return m(imgs)

    return apply_fn, model
