"""Fused 3x3 conv + bias + instance norm (+ReLU): the CUDA kernel in
``csrc/conv3_in.cu`` and its plain PyTorch version.

Replaces the JAX package's ``kernels/convin_pallas.py`` forward
(``_convin_fwd_impl`` -> ``_convin_kernel``): a pad-1 3x3 stride-1 conv
(reflect or zeros) + bias, fp32 channel moments of the conv output, then
normalize + affine (+ReLU). Same signature as the JAX ``conv3_in_act``;
x is NHWC and w is HWIO (3, 3, C, F), which the kernel reads as the (9C, F)
matrix of an implicit GEMM.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uig_torch.kernels import _build
from uig_torch.kernels._check import cuda_operand, on_cpu
from uig_torch.kernels.norm import instance_norm_reference

_BM = 128  # output pixels per conv tile (csrc/conv3_in.cu kBM)


def _check_pad_mode(pad_mode: str) -> None:
    if pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")


def conv3_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    pad_mode: str) -> torch.Tensor:
    """The conv half alone: NHWC x, HWIO w, pad 1, stride 1, + bias."""
    xn = x.permute(0, 3, 1, 2)
    wt = w.permute(3, 2, 0, 1)
    if pad_mode == "reflect":
        y = F.conv2d(F.pad(xn, (1, 1, 1, 1), mode="reflect"), wt, b)
    else:
        y = F.conv2d(xn, wt, b, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3_in_act_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           g: torch.Tensor, be: torch.Tensor, *, relu: bool,
                           eps: float = 1e-5,
                           pad_mode: str = "reflect") -> torch.Tensor:
    _check_pad_mode(pad_mode)
    return instance_norm_reference(conv3_reference(x, w, b, pad_mode), g, be,
                                   eps, relu)


def conv3_in_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 g: torch.Tensor, be: torch.Tensor, *, relu: bool,
                 eps: float = 1e-5, pad_mode: str = "reflect") -> torch.Tensor:
    """Pad-1 3x3 stride-1 conv + bias + InstanceNorm(scale=g, bias=be)
    (+ReLU). x: (B, H, W, C); w: (3, 3, C, F). Output (B, H, W, F)."""
    _check_pad_mode(pad_mode)
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3_in_act: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if on_cpu("conv3_in_act", x, w, b, g, be):
        return conv3_in_act_reference(x, w, b, g, be, relu=relu, eps=eps,
                                      pad_mode=pad_mode)
    nb, h, wd, c = x.shape
    f = w.shape[3]
    if c % 4 or f % 4:
        raise ValueError(f"conv3_in_act: C={c} and F={f} must be multiples of 4")
    if pad_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("conv3_in_act: reflect padding needs H, W >= 2")
    name = "conv3_in_act"
    cuda_operand(name, "x", x)
    cuda_operand(name, "w", w)
    for what, t in (("b", b), ("g", g), ("be", be)):
        cuda_operand(name, what, t, (f,))
    tiles = -(-(h * wd) // _BM)
    yconv = torch.empty((nb, h, wd, f), device=x.device, dtype=torch.float32)
    y = torch.empty_like(yconv)
    part = torch.empty((2, nb, tiles, f), device=x.device, dtype=torch.float32)
    ss = torch.empty((2, nb, f), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _build.launch("uig_conv3_in_fwd", x, w, b, g, be, yconv, y, part, ss,
                      nb, h, wd, c, f, pad_mode == "reflect", bool(relu),
                      float(eps))
    conv3_in_act.launches += 1
    return y


conv3_in_act.launches = 0
