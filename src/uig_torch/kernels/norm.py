"""Instance norm: the forward CUDA kernel in ``csrc/instance_norm.cu``, the
backward in ``csrc/instance_norm_bwd.cu``, their plain PyTorch versions, and
``instance_norm_act``, the autograd function that pairs them.

Replaces the JAX package's ``kernels/norm_pallas.py`` (``_fwd_impl`` ->
``_in_fwd_kernel`` and ``_bwd_impl`` -> ``_in_bwd_kernel``). Numerics of the
JAX InstanceNorm: fp32 one-pass moments E[x], E[x^2] over (H, W), variance
clamped at 0, eps inside the square root, affine, optional fused ReLU. The
forward keeps its statistics, mean and 1/sqrt(var + eps) per (example,
channel), as a (2, B, C) fp32 tensor; the backward takes them, as the JAX
convin VJP takes its forward's, and with ReLU masks dy by the pre-activation
they give. x is NHWC, fp32 or bf16:
in bf16 the statistics are fp32 from the bf16 values and y (dx) is rounded
once; gamma, beta, dgamma and dbeta are fp32.
"""

from __future__ import annotations

import torch

from uig_torch.kernels import _build
from uig_torch.kernels._check import cuda_operand, on_cpu, storage_type

_TARGET_BLOCKS = 1024  # enough blocks in flight to fill 132 SMs several times
_BWD_BLOCKS = 528      # the backward's: 4 blocks of 256 threads an SM
_MIN_ROWS = 64         # pixels per chunk, at least


def _moments(x32: torch.Tensor, eps: float):
    mean = x32.mean(dim=(1, 2), keepdim=True)
    mean_sq = x32.square().mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


def _reference_fwd(x, gamma, beta, eps, relu):
    """(y, stats) in plain PyTorch; stats (2, B, C): mean and
    1/sqrt(var + eps)."""
    x32 = x.to(torch.float32)
    mean, r = _moments(x32, eps)
    y = (x32 - mean) * r * gamma.to(torch.float32) + beta.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), torch.stack((mean.flatten(1), r.flatten(1)))


def instance_norm_reference(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, eps: float = 1e-5,
                            relu: bool = False) -> torch.Tensor:
    return _reference_fwd(x, gamma, beta, eps, relu)[0]


def _chunks(b: int, hw: int, c: int, per_block: int = 32,
            target: int = _TARGET_BLOCKS) -> tuple[int, int]:
    """(chunks, pixels a chunk) that cut each image's ``hw`` pixels so that
    about ``target`` blocks of ``per_block`` channels cover the batch."""
    ctiles = -(-c // per_block)
    chunks = max(1, min(-(-target // (b * ctiles)), -(-hw // _MIN_ROWS)))
    rows = -(-hw // chunks)
    return -(-hw // rows), rows


def instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """Per-example, per-channel norm over (H, W) of NHWC ``x``, then
    ``* gamma + beta`` and ReLU if ``relu``."""
    return _instance_norm_fwd(x, gamma, beta, eps, relu)[0]


def _instance_norm_fwd(x, gamma, beta, eps, relu):
    """(y, stats): ``instance_norm``'s output and its statistics (2, B, C)."""
    if x.dim() != 4:
        raise ValueError(f"instance_norm: x must be (B, H, W, C), got {tuple(x.shape)}")
    if on_cpu("instance_norm", x, gamma, beta):
        return _reference_fwd(x, gamma, beta, eps, relu)
    b, h, w, c = x.shape
    if c % 4:
        raise ValueError(f"instance_norm: C={c} must be a multiple of 4")
    t = storage_type("instance_norm", "x", x)
    cuda_operand("instance_norm", "gamma", gamma, (c,))
    cuda_operand("instance_norm", "beta", beta, (c,))
    hw = h * w
    chunks, rows = _chunks(b, hw, c)
    y = torch.empty_like(x)
    part = torch.empty((2, b, chunks, c), device=x.device, dtype=torch.float32)
    # scale, shift, then the statistics
    ss = torch.empty((4, b, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _build.launch("uig_instance_norm_fwd", x, gamma, beta, y, part, ss,
                      b, hw, c, chunks, rows, float(eps), bool(relu),
                      t == torch.bfloat16)
    instance_norm.launches += 1
    return y, ss[2:]


instance_norm.launches = 0


def instance_norm_bwd_reference(x: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, dy: torch.Tensor,
                                stats: torch.Tensor, relu: bool = False):
    x32, dy32 = x.to(torch.float32), dy.to(torch.float32)
    g, be = gamma.to(torch.float32), beta.to(torch.float32)
    mean, r = (s[:, None, None, :] for s in stats)
    xhat = (x32 - mean) * r
    if relu:
        dy32 = torch.where(xhat * g + be > 0, dy32, 0.0)
    dyh = dy32 * g
    mean_dyh = dyh.mean(dim=(1, 2), keepdim=True)
    mean_dyh_x = (dyh * xhat).mean(dim=(1, 2), keepdim=True)
    dx = r * (dyh - mean_dyh - xhat * mean_dyh_x)
    dgamma = (dy32 * xhat).sum(dim=(0, 1, 2))
    dbeta = dy32.sum(dim=(0, 1, 2))
    return dx.to(x.dtype), dgamma, dbeta


def instance_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      dy: torch.Tensor, stats: torch.Tensor,
                      relu: bool = False):
    """(dx, dgamma, dbeta) of ``instance_norm(x, gamma, beta, eps, relu)``
    for the output gradient ``dy``, from the statistics ``stats`` (2, B, C)
    fp32 that its forward kept: mean and 1/sqrt(var + eps)."""
    if x.dim() != 4 or dy.shape != x.shape:
        raise ValueError(f"instance_norm_bwd: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} must be one (B, H, W, C) shape")
    b, h, w, c = x.shape
    if tuple(stats.shape) != (2, b, c):
        raise ValueError(f"instance_norm_bwd: stats has shape "
                         f"{tuple(stats.shape)}, expected {(2, b, c)}")
    if on_cpu("instance_norm_bwd", x, gamma, beta, dy, stats):
        return instance_norm_bwd_reference(x, gamma, beta, dy, stats, relu)
    if c % 4:
        raise ValueError(f"instance_norm_bwd: C={c} must be a multiple of 4")
    name = "instance_norm_bwd"
    t = storage_type(name, "x", x)
    cuda_operand(name, "dy", dy, dtypes=(t,))
    cuda_operand(name, "gamma", gamma, (c,))
    cuda_operand(name, "beta", beta, (c,))
    cuda_operand(name, "stats", stats, (2, b, c))
    hw = h * w
    qb = min(c // 4, 32)  # channel quads a block
    chunks, rows = _chunks(b, hw, c, 4 * qb, _BWD_BLOCKS)
    dx = torch.empty_like(x)
    dparams = torch.empty((2, c), device=x.device, dtype=torch.float32)
    # one scratch: the per-chunk partials (2, B, chunks, C), the per-(b, c)
    # sums (2, B, C), then one int32 ticket a channel group
    scratch = torch.empty((2 * b * (chunks + 1) * c + -(-c // (4 * qb)),),
                          device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _build.launch("uig_instance_norm_bwd", x, gamma, beta, dy, stats, dx,
                      dparams, scratch, b, hw, c, chunks, rows, qb,
                      bool(relu), t == torch.bfloat16)
    instance_norm_bwd.launches += 1
    dgamma, dbeta = dparams.unbind()
    return dx, dgamma, dbeta


instance_norm_bwd.launches = 0


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu):
        y, stats = _instance_norm_fwd(x, gamma, beta, eps, relu)
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, stats = ctx.saved_tensors
        dx, dgamma, dbeta = instance_norm_bwd(x, gamma, beta,
                                              dy.contiguous(), stats,
                                              ctx.relu)
        return dx, dgamma, dbeta, None, None


def instance_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """``instance_norm`` with a gradient: K2f forward, K2b backward."""
    return _InstanceNorm.apply(x, gamma, beta, float(eps), bool(relu))
