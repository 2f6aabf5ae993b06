"""Reflect padding of NHWC tensors with a deterministic adjoint, in plain
PyTorch.

PyTorch's own reflection-pad backward accumulates with atomics on CUDA (and
refuses to run under ``torch.use_deterministic_algorithms``). Here the
adjoint adds each ring value onto its mirrored source one slice at a time,
columns first and then rows, the order of the JAX package's
``conv_pallas._fold_block``: the same bits on every run. The padding itself
is PyTorch's ``reflect`` mode (no edge repeat), a gather.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_fold(g: torch.Tensor, p: int) -> torch.Tensor:
    """Adjoint of ``reflect_pad(x, p)``: (B, H + 2p, W + 2p, C) -> (B, H, W,
    C). Padded column ``p - k`` mirrors onto column ``k``, padded column
    ``p + W - 1 + k`` onto ``W - 1 - k`` (k = 1..p); rows likewise."""
    if p == 0:
        return g
    w = g.shape[2] - 2 * p
    cols = g[:, :, p:p + w].clone()
    for k in range(1, p + 1):
        cols[:, :, k] += g[:, :, p - k]
        cols[:, :, w - 1 - k] += g[:, :, p + w - 1 + k]
    h = g.shape[1] - 2 * p
    out = cols[:, p:p + h].clone()
    for k in range(1, p + 1):
        out[:, k] += cols[:, p - k]
        out[:, h - 1 - k] += cols[:, p + h - 1 + k]
    return out


class _ReflectPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                     mode="reflect").permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return reflect_fold(g, ctx.p), None


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad the two spatial dims of NHWC ``x`` by ``p`` (needs H, W
    > p), with the fixed-order adjoint ``reflect_fold``."""
    if x.shape[1] <= p or x.shape[2] <= p:
        raise ValueError(f"reflect padding {p} needs H, W > {p}, got "
                         f"{tuple(x.shape)}")
    return _ReflectPad.apply(x, int(p))
