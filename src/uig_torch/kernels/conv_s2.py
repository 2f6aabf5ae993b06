"""The generator's 3x3 stride-2 pad-1 downsample conv (d128, d256) and the
generic VALID conv, with their gradients: the CUDA kernels behind
``csrc/conv3s2.cu`` (``csrc/conv3s2_tf32.cu``, ``csrc/conv3s2_tc.cu``),
their plain PyTorch versions, and the autograd functions that pair them.

Replaces the JAX package's ``kernels/conv_pallas.py`` ``conv3s2_s2d`` and
``conv_core`` (both through ``conv_core5`` -> ``_conv5_impl``; the backward
``_make_conv5.bwd``: ``_conv5_impl`` with ``_dgrad_weights`` and
``_wgrad5_impl``). Same linear maps; the TPU's space-to-depth view is a lane
trick and is not carried over.

Three launches, each in fp32 or bf16 (x, w, the bias and dy of one type,
every sum in fp32, each output rounded once; the plain versions compute in
fp32 from the widened inputs and round once):

  * ``conv3s2(x, w, bias)``: (B, H, W, Cin) -> (B, H/2, W/2, Cout) on even
    H, W, zero padding 1; the bias is added in fp32 before the rounding;
  * ``conv3s2_dgrad(dy, w)``: its adjoint in x;
  * ``conv3s2_wgrad(x, dy)``: its weight gradient, (3, 3, Cin, Cout) in x's
    type.

Two designs, chosen by the type:

  * fp32, all three, "tf32x3": the tensor cores in the three-term TF32
    split (``wgmma``, ``csrc/conv3s2_tf32.cu``), which keeps fp32's order of
    error, as the fp32 training step and fp32 serving want; the forward
    reads W^T's hi/lo planes and the dgrad the HWIO weight's, each written
    by a split kernel into a scratch allocated here;
  * bf16, all three, "wgmma": the tensor cores on bf16 products
    (``csrc/conv3s2_tc.cu``).

``conv_core(xp, w_flat, kh, kw)`` is JAX's generic square VALID stride-1
conv with flat (kh kw Cin, Cout) weights, differentiable, through the same
kernels with stride 1 and no padding; no model routes it (as in JAX). Its
launches count in ``conv_core.launches``, not in the main path's kernels.
Channel counts must be multiples of 4 on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uig_torch.kernels import _build
from uig_torch.kernels._check import cuda_operand, on_cpu, storage_type

# wgrad blocks in all. Both designs give a block two slices of _SLICE
# channels of one tap x _BN of F. wgmma (bf16, csrc/conv3s2_tc.cu): the 2
# blocks an SM holds at once (97 KB of shared memory each), one wave, each
# summing its chunk _TC_BK pixels a stage. tf32x3 (fp32,
# csrc/conv3s2_tf32.cu): one block an SM (209 KB), two waves at most,
# _TF_BK pixels a stage.
_WGRAD_BLOCKS = 264
_SLICE, _BN = 64, 128
_TC_BK, _TF_BK = 64, 32
MAX_K = 7


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.to(torch.float32)


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


# ------------------------------------------------------------ plain versions


def _conv_reference(x, w, bias, stride: int, pad: int) -> torch.Tensor:
    y = F.conv2d(_f32(x).permute(0, 3, 1, 2), _f32(w).permute(3, 2, 0, 1),
                 _f32(bias), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _dgrad_reference(dy, w, size, stride: int, pad: int) -> torch.Tensor:
    dx = torch.nn.grad.conv2d_input(
        (dy.shape[0], w.shape[2]) + tuple(size), _f32(w).permute(3, 2, 0, 1),
        _f32(dy).permute(0, 3, 1, 2), stride=stride, padding=pad)
    return dx.permute(0, 2, 3, 1).to(dy.dtype).contiguous()


def _wgrad_reference(x, dy, k: int, stride: int, pad: int) -> torch.Tensor:
    dw = torch.nn.grad.conv2d_weight(
        _f32(x).permute(0, 3, 1, 2), (dy.shape[3], x.shape[3], k, k),
        _f32(dy).permute(0, 3, 1, 2), stride=stride, padding=pad)
    return dw.permute(2, 3, 1, 0).to(x.dtype).contiguous()


def conv3s2_reference(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None) -> torch.Tensor:
    return _conv_reference(x, w, bias, 2, 1)


def conv3s2_dgrad_reference(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _dgrad_reference(dy, w, (2 * dy.shape[1], 2 * dy.shape[2]), 2, 1)


def conv3s2_wgrad_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return _wgrad_reference(x, dy, 3, 2, 1)


def conv_core_reference(xp: torch.Tensor, w: torch.Tensor, kh: int,
                        kw: int) -> torch.Tensor:
    return _conv_reference(xp, w.reshape(kh, kw, xp.shape[3], -1), None, 1, 0)


# ------------------------------------------------------------------ launches


def _channels(name: str, cin: int, cout: int, k: int) -> None:
    if cin % 4 or cout % 4:
        raise ValueError(f"{name}: Cin={cin} and Cout={cout} must be "
                         "multiples of 4")
    if k > MAX_K:
        raise ValueError(f"{name}: a {k}x{k} window exceeds {MAX_K}x{MAX_K}")


def _fwd(name, x, w, bias, stride: int, pad: int) -> torch.Tensor:
    nb, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    _channels(name, cin, cout, k)
    t = storage_type(name, "x", x)
    cuda_operand(name, "w", w, dtypes=(t,))
    if bias is not None:
        cuda_operand(name, "bias", bias, (cout,), dtypes=(t,))
    y = torch.empty((nb, _out(h, k, stride, pad), _out(wd, k, stride, pad),
                     cout), device=x.device, dtype=t)
    ws = (None if t == torch.bfloat16  # tf32x3: W^T's hi/lo planes
          else torch.empty((2, cout, k * k * -(-cin // 32) * 32),
                           device=x.device, dtype=torch.float32))
    with torch.cuda.device(x.device):
        _build.launch("uig_conv_fwd", x, w, ws, bias, y, nb, h, wd, cin, cout,
                      k, stride, pad, t == torch.bfloat16)
    return y


def _dgrad(name, dy, w, size, stride: int, pad: int) -> torch.Tensor:
    nb, _, _, cout = dy.shape
    k, cin = w.shape[0], w.shape[2]
    h, wd = size
    _channels(name, cin, cout, k)
    t = storage_type(name, "dy", dy)
    cuda_operand(name, "w", w, dtypes=(t,))
    if t == torch.bfloat16:  # wgmma reads wt (k, k, Cout, Cin), no scratch
        wk, ws = w.permute(0, 1, 3, 2).contiguous(), None
    else:  # tf32x3: w as it lies, its hi/lo planes (2, k k Cin, Cout_p)
        wk = w
        ws = torch.empty((2, k * k * cin, -(-cout // 32) * 32),
                         device=dy.device, dtype=torch.float32)
    dx = torch.empty((nb, h, wd, cin), device=dy.device, dtype=t)
    with torch.cuda.device(dy.device):
        _build.launch("uig_conv_dgrad", dy, wk, ws, dx, nb, h, wd, cin, cout,
                      k, stride, pad, t == torch.bfloat16)
    return dx


def _wgrad_chunks(k: int, cin: int, cout: int, pixels: int,
                  bf16: bool) -> tuple[int, int]:
    """(chunks, pixels per chunk) of the weight gradient's ordered pixel
    chunks: chunk z sums pixels [z per, min((z + 1) per, pixels)), each
    chunk but the last whole stages of the design's pixels. About
    _WGRAD_BLOCKS blocks in all on wgmma (bf16), at most _WGRAD_BLOCKS on
    tf32x3 (fp32)."""
    tiles = -(-(k * k * -(-cin // _SLICE)) // 2) * -(-cout // _BN)
    bk, blocks = ((_TC_BK, -(-_WGRAD_BLOCKS // tiles)) if bf16
                  else (_TF_BK, _WGRAD_BLOCKS // tiles))
    stages = -(-pixels // bk)
    per = bk * -(-stages // max(1, min(stages, blocks)))
    return -(-pixels // per), per


def _wgrad(name, x, dy, k: int, stride: int, pad: int) -> torch.Tensor:
    nb, h, wd, cin = x.shape
    cout = dy.shape[3]
    _channels(name, cin, cout, k)
    t = storage_type(name, "x", x)
    cuda_operand(name, "dy", dy, dtypes=(t,))
    m = k * k * cin
    chunks, per = _wgrad_chunks(k, cin, cout, nb * dy.shape[1] * dy.shape[2],
                                t == torch.bfloat16)
    part = torch.empty((chunks, m, cout), device=x.device, dtype=torch.float32)
    dw = torch.empty((k, k, cin, cout), device=x.device, dtype=t)
    with torch.cuda.device(x.device):
        _build.launch("uig_conv_wgrad", x, dy, part, dw, nb, h, wd, cin, cout,
                      k, stride, pad, chunks, per, t == torch.bfloat16)
    return dw


def _check_s2(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name}: H and W must be even, got "
                         f"{tuple(x.shape[1:3])}")


def conv3s2(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """Zero-pad-1 3x3 stride-2 conv + bias: x (B, H, W, Cin) with even H, W;
    w (3, 3, Cin, Cout); bias (Cout,) or None; one type, fp32 or bf16.
    Output (B, H/2, W/2, Cout) in that type."""
    _check_s2("conv3s2", x, w)
    tensors = (x, w) if bias is None else (x, w, bias)
    if on_cpu("conv3s2", *tensors):
        return conv3s2_reference(x, w, bias)
    y = _fwd("conv3s2", x, w, bias, 2, 1)
    conv3s2.launches += 1
    return y


conv3s2.launches = 0


def conv3s2_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of ``conv3s2``: dy (B, H/2, W/2, Cout), w (3, 3, Cin,
    Cout) -> dx (B, H, W, Cin)."""
    if dy.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[3] != dy.shape[3]:
        raise ValueError(f"conv3s2_dgrad: bad shapes dy {tuple(dy.shape)}, "
                         f"w {tuple(w.shape)}")
    if on_cpu("conv3s2_dgrad", dy, w):
        return conv3s2_dgrad_reference(dy, w)
    dx = _dgrad("conv3s2_dgrad", dy, w, (2 * dy.shape[1], 2 * dy.shape[2]),
                2, 1)
    conv3s2_dgrad.launches += 1
    return dx


conv3s2_dgrad.launches = 0


def conv3s2_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``conv3s2``: x (B, H, W, Cin), dy (B, H/2, W/2,
    Cout) -> dw (3, 3, Cin, Cout) in x's type (summed in fp32, rounded
    once)."""
    if x.dim() != 4 or dy.dim() != 4 or x.shape[0] != dy.shape[0] \
            or (x.shape[1], x.shape[2]) != (2 * dy.shape[1], 2 * dy.shape[2]):
        raise ValueError(f"conv3s2_wgrad: bad shapes x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}")
    if on_cpu("conv3s2_wgrad", x, dy):
        return conv3s2_wgrad_reference(x, dy)
    dw = _wgrad("conv3s2_wgrad", x, dy, 3, 2, 1)
    conv3s2_wgrad.launches += 1
    return dw


conv3s2_wgrad.launches = 0


def _bias_grad(dy: torch.Tensor, bias_dtype) -> torch.Tensor:
    return dy.to(torch.float32).sum(dim=(0, 1, 2)).to(bias_dtype)


class _Conv3s2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return conv3s2(x, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        need = ctx.needs_input_grad
        dx = conv3s2_dgrad(dy, w) if need[0] else None
        dw = conv3s2_wgrad(x, dy) if need[1] else None
        db = (_bias_grad(dy, ctx.bias_dtype)
              if ctx.bias_dtype is not None and need[2] else None)
        return dx, dw, db


def conv3s2_act(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None) -> torch.Tensor:
    """``conv3s2`` with a gradient: K4s forward, dgrad and wgrad."""
    return _Conv3s2.apply(x, w, bias)


class _ConvCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, w, kh):
        ctx.save_for_backward(xp, w)
        ctx.kh = kh
        w4 = w.reshape(kh, kh, xp.shape[3], -1)
        if on_cpu("conv_core", xp, w):
            return conv_core_reference(xp, w, kh, kh)
        y = _fwd("conv_core", xp, w4.contiguous(), None, 1, 0)
        conv_core.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        xp, w = ctx.saved_tensors
        k = ctx.kh
        dy = dy.contiguous()
        w4 = w.reshape(k, k, xp.shape[3], -1)
        need = ctx.needs_input_grad
        dx = dw = None
        if on_cpu("conv_core", dy, w):
            if need[0]:
                dx = _dgrad_reference(dy, w4, xp.shape[1:3], 1, 0)
            if need[1]:
                dw = _wgrad_reference(xp, dy, k, 1, 0)
        else:
            if need[0]:
                dx = _dgrad("conv_core", dy, w4.contiguous(), xp.shape[1:3],
                            1, 0)
                conv_core.launches += 1
            if need[1]:
                dw = _wgrad("conv_core", xp, dy, k, 1, 0)
                conv_core.launches += 1
        return dx, None if dw is None else dw.reshape(w.shape), None


def conv_core(xp: torch.Tensor, w: torch.Tensor, kh: int,
              kw: int) -> torch.Tensor:
    """Differentiable VALID kh x kw stride-1 conv of a pre-padded NHWC plane
    ``xp`` by flat weights ``w`` (kh kw Cin, Cout), as the JAX package's
    ``conv_core``; square windows only."""
    if kh != kw:
        raise ValueError("conv_core: square windows only")
    if xp.dim() != 4 or w.dim() != 2 or w.shape[0] != kh * kw * xp.shape[3]:
        raise ValueError(f"conv_core: bad shapes xp {tuple(xp.shape)}, "
                         f"w {tuple(w.shape)} for a {kh}x{kw} window")
    return _ConvCore.apply(xp, w, int(kh))


conv_core.launches = 0
