"""Instance norm forward: the CUDA kernel in ``csrc/instance_norm.cu`` and
its plain PyTorch version.

Replaces the JAX package's ``kernels/norm_pallas.py`` forward
(``_fwd_impl`` -> ``_in_fwd_kernel``). Numerics of the JAX InstanceNorm: fp32
one-pass moments E[x], E[x^2] over (H, W), variance clamped at 0, eps inside
the square root, affine, optional fused ReLU. x is NHWC.
"""

from __future__ import annotations

import torch

from uig_torch.kernels import _build
from uig_torch.kernels._check import cuda_operand, on_cpu

_TARGET_BLOCKS = 1024  # enough blocks in flight to fill 132 SMs several times
_MIN_ROWS = 64         # pixels per chunk, at least


def instance_norm_reference(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, eps: float = 1e-5,
                            relu: bool = False) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=(1, 2), keepdim=True)
    mean_sq = x32.square().mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps) * gamma.to(torch.float32) \
        + beta.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _chunks(b: int, hw: int, c: int) -> tuple[int, int]:
    ctiles = -(-c // 32)
    chunks = max(1, min(-(-_TARGET_BLOCKS // (b * ctiles)),
                        -(-hw // _MIN_ROWS)))
    rows = -(-hw // chunks)
    return -(-hw // rows), rows


def instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """Per-example, per-channel norm over (H, W) of NHWC ``x``, then
    ``* gamma + beta`` and ReLU if ``relu``."""
    if x.dim() != 4:
        raise ValueError(f"instance_norm: x must be (B, H, W, C), got {tuple(x.shape)}")
    if on_cpu("instance_norm", x, gamma, beta):
        return instance_norm_reference(x, gamma, beta, eps, relu)
    b, h, w, c = x.shape
    if c % 4:
        raise ValueError(f"instance_norm: C={c} must be a multiple of 4")
    cuda_operand("instance_norm", "x", x)
    cuda_operand("instance_norm", "gamma", gamma, (c,))
    cuda_operand("instance_norm", "beta", beta, (c,))
    hw = h * w
    chunks, rows = _chunks(b, hw, c)
    y = torch.empty_like(x)
    part = torch.empty((2, b, chunks, c), device=x.device, dtype=torch.float32)
    ss = torch.empty((2, b, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _build.launch("uig_instance_norm_fwd", x, gamma, beta, y, part, ss,
                      b, hw, c, chunks, rows, float(eps), bool(relu))
    instance_norm.launches += 1
    return y


instance_norm.launches = 0
