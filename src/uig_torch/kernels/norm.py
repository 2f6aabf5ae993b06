"""Instance norm: the forward CUDA kernel in ``csrc/instance_norm_fwd.cu``
(entry point in ``csrc/instance_norm.cu``), the backward in
``csrc/instance_norm_bwd.cu``, their plain PyTorch versions, and
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
once; gamma, beta, dgamma and dbeta are fp32. Both kernels take any C.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from uig_torch.kernels import _build
from uig_torch.kernels._check import cuda_operand, on_cpu, storage_type

_BWD_BLOCKS = 528      # the backward's: 4 blocks of 256 threads an SM
_MIN_ROWS = 64         # pixels per chunk, at least
# The forward kernel (csrc/instance_norm_fwd.cu): its consumer threads and
# ring stage size; the plan's ring (12 stages of 16 KB, one block an SM), a
# resident task's stages at most (the rest of the ring takes the next
# task's first stages), a task's size where the runs cannot stay
# resident, and the reducer blocks.
_FWD_THREADS = 256
_STAGE_BYTES = 16384
_FWD_RING = 12
_RESIDENT_STAGES = 9
_TASK_BYTES = 64 << 10
_FWD_REDUCERS = 4


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


def _chunks(b: int, hw: int, c: int, per_block: int,
            target: int) -> tuple[int, int]:
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


class FwdPlan(NamedTuple):
    """How the forward kernel cuts one call: see ``fwd_plan``."""
    vec: bool        # 16-byte columns staged in shared memory, or scalars
    resident: bool   # vec: a task's staged run stays for its apply
    ring: int        # ring stages (vec)
    lanes: int       # pixel lanes of a task's 256 threads
    stage_rows: int  # pixels a ring stage (vec), a multiple of lanes
    fin_lanes: int   # finalize threads a piece of channels
    rows: int        # pixels a task
    chunks: int      # tasks an image, of each kind
    group: int       # images a group
    reducers: int    # blocks that finalize the images
    grid: int        # blocks, resident at once


@functools.lru_cache(maxsize=None)
def fwd_plan(b: int, hw: int, c: int, isz: int, sms: int,
             reducers: int = _FWD_REDUCERS,
             resident_stages: int = _RESIDENT_STAGES) -> FwdPlan:
    """The forward kernel's plan for x of (b, hw, c) with ``isz``-byte
    elements on a card of ``sms`` SMs, one block an SM: ``reducers``
    blocks finalize the images from the chunk partials (``fin_lanes``
    lanes of 256 threads a piece of 4 channels, or 1 where C % 4 != 0); the
    other blocks each take one task of every group of ``group`` images
    (``chunks`` runs of ``rows`` pixels an image). A pixel row is ``c *
    isz`` bytes; where that is a multiple of 16 and at most 256 columns of
    16 bytes, a thread holds one column (``vec``) and runs are staged in a
    ``ring`` of 16 KB stages of ``stage_rows`` pixels. Where a group's
    tasks fit the blocks and a run at most ``resident_stages`` stages, the
    run stays in the ring from its moments to its apply (``resident``: x
    is read from device memory once); else runs of about 64 KB are staged
    twice, a group apart. ``reducers`` and ``resident_stages`` change only
    for the card tests of the kernel's schedule."""
    row = c * isz
    vec = row % 16 == 0 and row <= 16 * _FWD_THREADS
    width = row // 16 if vec else min(c, _FWD_THREADS)
    lanes = _FWD_THREADS // width
    stage_rows = lanes * (_STAGE_BYTES // (lanes * row)) if vec else 0
    reducers = min(reducers, b)
    blocks = sms - reducers
    fin_lanes = _FWD_THREADS // min(c // 4 if c % 4 == 0 else c,
                                    _FWD_THREADS)
    # resident: the fewest chunks whose runs fit, as many images a group
    # as the blocks take, then more chunks (a stage's pixels at least)
    chunks = -(-hw // (stage_rows * resident_stages)) if vec else blocks + 1
    resident = vec and chunks <= blocks
    if resident:
        group = min(b, blocks // chunks)
        chunks = max(chunks, min(blocks // group, -(-hw // stage_rows)))
    else:
        chunks = -(-hw // max(1, _TASK_BYTES // row))
        group = max(1, min(b, blocks // chunks))
    rows = -(-hw // chunks)
    chunks = -(-hw // rows)
    grid = reducers + min(blocks, group * chunks)
    return FwdPlan(vec, resident, _FWD_RING if vec else 0, lanes, stage_rows,
                   fin_lanes, rows, chunks, group, reducers, grid)


_SMS: dict = {}    # device index -> SM count
_SYNC: dict = {}   # (device index, stream) -> the kernel's int32 counters


def _sync_buffer(dev: int, stream: int, n: int) -> torch.Tensor:
    """The forward kernel's counters on ``stream``: an exit count, then a
    count of moment tasks and a ready flag an image, zero between launches
    (the kernel's last block sets them back). One buffer a stream, so that
    launches on one buffer run in stream order; it grows with the batch."""
    buf = _SYNC.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32,
                          device=torch.device("cuda", dev))
        _SYNC[(dev, stream)] = buf
    return buf


def _instance_norm_fwd(x, gamma, beta, eps, relu):
    """(y, stats): ``instance_norm``'s output and its statistics (2, B, C)."""
    if x.dim() != 4:
        raise ValueError(f"instance_norm: x must be (B, H, W, C), got {tuple(x.shape)}")
    if on_cpu("instance_norm", x, gamma, beta):
        return _reference_fwd(x, gamma, beta, eps, relu)
    b, h, w, c = x.shape
    storage_type("instance_norm", "x", x)
    cuda_operand("instance_norm", "gamma", gamma, (c,))
    cuda_operand("instance_norm", "beta", beta, (c,))
    dev = x.device.index
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    plan = fwd_plan(b, h * w, c, x.element_size(), sms)
    return _fwd_launch(x, gamma, beta, eps, relu, plan)


def _fwd_launch(x, gamma, beta, eps, relu, plan: FwdPlan):
    """One launch of the forward kernel on checked operands, by ``plan``."""
    b, h, w, c = x.shape
    dev = x.device.index
    y = torch.empty_like(x)
    # one scratch: ss (4, B, C), scale, shift, mean, rstd, placed so that
    # the statistics start 16-byte aligned, then the chunk partials (2, B,
    # chunks, C)
    pad = -2 * b * c % 4
    scratch = torch.empty(pad + 4 * b * c + 2 * b * plan.chunks * c,
                          device=x.device, dtype=torch.float32)
    ss = scratch.data_ptr() + 4 * pad
    stream = torch._C._cuda_getCurrentRawStream(dev)
    args = (x, gamma, beta, y, ss, ss + 16 * b * c,
            _sync_buffer(dev, stream, 1 + 2 * b), b, h * w, c, plan.chunks,
            plan.rows, plan.group, plan.reducers, plan.resident, plan.ring,
            plan.lanes, plan.stage_rows, plan.fin_lanes, plan.vec, plan.grid,
            float(eps), bool(relu), x.dtype == torch.bfloat16)
    if dev == torch.cuda.current_device():
        _build.launch("uig_instance_norm_fwd", *args, stream=stream)
    else:
        with torch.cuda.device(dev):
            _build.launch("uig_instance_norm_fwd", *args, stream=stream)
    instance_norm.launches += 1
    return y, scratch[pad + 2 * b * c:pad + 4 * b * c].view(2, b, c)


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
    name = "instance_norm_bwd"
    t = storage_type(name, "x", x)
    cuda_operand(name, "dy", dy, dtypes=(t,))
    cuda_operand(name, "gamma", gamma, (c,))
    cuda_operand(name, "beta", beta, (c,))
    cuda_operand(name, "stats", stats, (2, b, c))
    hw = h * w
    # channels a thread's piece, pieces a block: 4-channel pieces where C
    # allows them, else one channel
    wq, qb = (4, min(c // 4, 32)) if c % 4 == 0 else (1, min(c, 128))
    chunks, rows = _chunks(b, hw, c, wq * qb, _BWD_BLOCKS)
    dx = torch.empty_like(x)
    dparams = torch.empty((2, c), device=x.device, dtype=torch.float32)
    # one scratch: the per-chunk partials (2, B, chunks, C), the per-(b, c)
    # sums (2, B, C), then one int32 ticket a channel group
    scratch = torch.empty((2 * b * (chunks + 1) * c + -(-c // (wq * qb)),),
                          device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _build.launch("uig_instance_norm_bwd", x, gamma, beta, dy, stats, dx,
                      dparams, scratch, b, hw, c, chunks, rows, wq, qb,
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
