"""The 7x7 stride-1 pad-3 conv + bias for few output channels: the forward
CUDA kernels behind ``csrc/conv7.cu`` (on the tensor cores: fp32 in the
three-term TF32 split in ``csrc/conv7_tf32.cu``, bf16 in
``csrc/conv7_tc.cu``), its input and weight gradients behind
``csrc/conv7_bwd.cu`` (on the tensor cores too: fp32 in the split in
``csrc/conv7_bwd_tf32.cu`` and ``csrc/conv7_wgrad_tf32.cu``, bf16 in
``csrc/conv7_bwd_tc.cu`` and ``csrc/conv7_wgrad_tc.cu``), their plain
PyTorch versions, and ``conv7_act``, the autograd function that pairs them.

Replaces the JAX package's ``kernels/conv_pallas.py`` ``conv7_s2d`` (through
``conv_core5`` -> ``_conv5_impl`` -> ``_conv5_kernel``; the backward's
``_conv5_impl`` with ``fold=True`` and ``_wgrad5_impl``). Same linear map;
the TPU's space-to-depth view is a lane trick and is not carried over. x is
NHWC, w is HWIO (7, 7, Cin, Cout) with Cout <= 4. x, w, the bias and dy are
fp32 or all bf16 (the bias already rounded to bf16, as JAX's PadConv casts
it); every sum is fp32 and each output is rounded once to that type. The
plain versions compute in fp32 from the widened inputs and round once.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from uig_torch.kernels import _build
from uig_torch.kernels._check import cuda_operand, on_cpu, storage_type
from uig_torch.kernels.reflect import reflect_fold

MAX_COUT = 4
MAX_CIN_BF16 = 256  # the bf16 forward's source rows and B in shared memory
MAX_CIN_FP32 = 112  # the fp32 forward's B (hi and lo) and two source rows
_WTILE_TC = (32, 128)  # bf16 wgrad tile (csrc/conv7_wgrad_tc.cu kTR, kTW)
_WTILE_TF32 = (16, 58)  # fp32 wgrad tile (csrc/conv7_wgrad_tf32.cu kTR, TW)
_WTILE_TF32_CO4 = 26    # its strip at Cout 4 (TW)


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.to(torch.float32)


def conv7_reference(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor | None,
                    pad_mode: str = "reflect") -> torch.Tensor:
    xn = _f32(x).permute(0, 3, 1, 2)
    wt = _f32(w).permute(3, 2, 0, 1)
    bias = _f32(bias)
    if pad_mode == "reflect":
        y = F.conv2d(F.pad(xn, (3, 3, 3, 3), mode="reflect"), wt, bias)
    elif pad_mode == "zeros":
        y = F.conv2d(xn, wt, bias, padding=3)
    else:
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check_pad_mode(pad_mode: str) -> None:
    if pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")


def takes_cin(cin: int, dtype: torch.dtype) -> bool:
    """Whether the card's kernels (forward, input and weight gradients)
    take Cin in ``dtype``: bf16 a multiple of 4 up to MAX_CIN_BF16, fp32 up
    to MAX_CIN_FP32."""
    if dtype == torch.bfloat16:
        return cin % 4 == 0 and cin <= MAX_CIN_BF16
    return cin <= MAX_CIN_FP32


def _check_card(name: str, h: int, wd: int, cin: int, cout: int,
                pad_mode: str, dtype: torch.dtype) -> None:
    """The shapes the card's kernels take, one check for all three, so that
    the backward takes every head the forward took."""
    if cout > MAX_COUT:
        raise ValueError(f"{name}: Cout={cout} > {MAX_COUT}")
    if pad_mode == "reflect" and (h < 4 or wd < 4):
        raise ValueError(f"{name}: reflect padding needs H, W >= 4")
    if takes_cin(cin, dtype):
        return
    if dtype == torch.bfloat16:
        raise ValueError(f"{name}: bf16 takes Cin a multiple of 4 up to "
                         f"{MAX_CIN_BF16}, got {cin}")
    raise ValueError(f"{name}: fp32 takes Cin up to {MAX_CIN_FP32}, got {cin}")


def conv7(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
          pad_mode: str = "reflect") -> torch.Tensor:
    """pad-3 7x7 stride-1 conv + bias. x: (B, H, W, Cin); w: (7, 7, Cin,
    Cout), Cout <= 4; bias (Cout,) or None; one type, fp32 or bf16. Output
    (B, H, W, Cout) in that type."""
    if x.dim() != 4 or tuple(w.shape[:2]) != (7, 7) or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv7: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    cout = w.shape[3]
    if bias is None:
        bias = torch.zeros((cout,), device=x.device, dtype=x.dtype)
    if on_cpu("conv7", x, w, bias):
        return conv7_reference(x, w, bias, pad_mode)
    _check_pad_mode(pad_mode)
    nb, h, wd, cin = x.shape
    t = storage_type("conv7", "x", x)
    _check_card("conv7", h, wd, cin, cout, pad_mode, t)
    cuda_operand("conv7", "w", w, dtypes=(t,))
    cuda_operand("conv7", "bias", bias, (cout,), dtypes=(t,))
    y = torch.empty((nb, h, wd, cout), device=x.device, dtype=t)
    with torch.cuda.device(x.device):
        _build.launch("uig_conv7_fwd", x, w, bias, y, nb, h, wd, cin, cout,
                      pad_mode == "reflect", t == torch.bfloat16)
    conv7.launches += 1
    return y


conv7.launches = 0


def conv7_dgrad_reference(dy: torch.Tensor, w: torch.Tensor,
                          pad_mode: str = "reflect") -> torch.Tensor:
    nb, h, wd, _ = dy.shape
    cin = w.shape[2]
    wt = _f32(w).permute(3, 2, 0, 1)
    dyn = _f32(dy).permute(0, 3, 1, 2)
    if pad_mode == "reflect":
        dxp = torch.nn.grad.conv2d_input((nb, cin, h + 6, wd + 6), wt, dyn)
        dx = reflect_fold(dxp.permute(0, 2, 3, 1), 3)
    else:
        _check_pad_mode(pad_mode)
        dx = torch.nn.grad.conv2d_input((nb, cin, h, wd), wt, dyn,
                                        padding=3).permute(0, 2, 3, 1)
    return dx.to(dy.dtype).contiguous()


def conv7_dgrad(dy: torch.Tensor, w: torch.Tensor,
                pad_mode: str = "reflect") -> torch.Tensor:
    """Input gradient of ``conv7``: dy (B, H, W, Cout), w (7, 7, Cin, Cout)
    -> dx (B, H, W, Cin), the reflect ring folded onto its sources (in
    fp32, rounded once)."""
    if dy.dim() != 4 or tuple(w.shape[:2]) != (7, 7) or w.shape[3] != dy.shape[3]:
        raise ValueError(f"conv7_dgrad: bad shapes dy {tuple(dy.shape)}, "
                         f"w {tuple(w.shape)}")
    if on_cpu("conv7_dgrad", dy, w):
        return conv7_dgrad_reference(dy, w, pad_mode)
    _check_pad_mode(pad_mode)
    nb, h, wd, cout = dy.shape
    cin = w.shape[2]
    t = storage_type("conv7_dgrad", "dy", dy)
    _check_card("conv7_dgrad", h, wd, cin, cout, pad_mode, t)
    cuda_operand("conv7_dgrad", "w", w, dtypes=(t,))
    dx = torch.empty((nb, h, wd, cin), device=dy.device, dtype=t)
    with torch.cuda.device(dy.device):
        _build.launch("uig_conv7_dgrad", dy, w, dx, nb, h, wd, cin, cout,
                      pad_mode == "reflect", t == torch.bfloat16)
    conv7_dgrad.launches += 1
    return dx


conv7_dgrad.launches = 0


def conv7_wgrad_reference(x: torch.Tensor, dy: torch.Tensor,
                          pad_mode: str = "reflect") -> torch.Tensor:
    xn = _f32(x).permute(0, 3, 1, 2)
    dyn = _f32(dy).permute(0, 3, 1, 2)
    shape = (dy.shape[3], x.shape[3], 7, 7)
    if pad_mode == "reflect":
        dw = torch.nn.grad.conv2d_weight(
            F.pad(xn, (3, 3, 3, 3), mode="reflect"), shape, dyn)
    else:
        _check_pad_mode(pad_mode)
        dw = torch.nn.grad.conv2d_weight(xn, shape, dyn, padding=3)
    return dw.permute(2, 3, 1, 0).to(x.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def conv7_wgrad(x: torch.Tensor, dy: torch.Tensor,
                pad_mode: str = "reflect") -> torch.Tensor:
    """Weight gradient of ``conv7``: x (B, H, W, Cin), dy (B, H, W, Cout)
    -> dw (7, 7, Cin, Cout) in x's type, against the padded plane the
    forward read (summed in fp32, rounded once)."""
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"conv7_wgrad: bad shapes x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}")
    if on_cpu("conv7_wgrad", x, dy):
        return conv7_wgrad_reference(x, dy, pad_mode)
    _check_pad_mode(pad_mode)
    nb, h, wd, cin = x.shape
    cout = dy.shape[3]
    t = storage_type("conv7_wgrad", "x", x)
    _check_card("conv7_wgrad", h, wd, cin, cout, pad_mode, t)
    cuda_operand("conv7_wgrad", "dy", dy, dtypes=(t,))
    # persistent blocks, one an SM, over the (B, rows, strips) tiles: bf16
    # a grid row of them for each 64-channel slice, fp32 one grid in all
    if t == torch.bfloat16:
        tiles = nb * -(-h // _WTILE_TC[0]) * -(-wd // _WTILE_TC[1])
        chunks = min(tiles, _sm_count(x.device))
    else:
        tw = _WTILE_TF32_CO4 if cout == 4 else _WTILE_TF32[1]
        tiles = nb * -(-h // _WTILE_TF32[0]) * -(-wd // tw)
        chunks = min(tiles, max(1, _sm_count(x.device) // -(-cin // 64)))
    part = torch.empty((chunks, 7, 7, cin, cout), device=x.device,
                       dtype=torch.float32)
    dw = torch.empty((7, 7, cin, cout), device=x.device, dtype=t)
    with torch.cuda.device(x.device):
        _build.launch("uig_conv7_wgrad", x, dy, part, dw, nb, h, wd, cin, cout,
                      pad_mode == "reflect", chunks, t == torch.bfloat16)
    conv7_wgrad.launches += 1
    return dw


conv7_wgrad.launches = 0


class _Conv7(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, pad_mode):
        ctx.save_for_backward(x, w)
        ctx.pad_mode = pad_mode
        ctx.bias_dtype = None if bias is None else bias.dtype
        return conv7(x, w, bias, pad_mode)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        need = ctx.needs_input_grad
        dx = conv7_dgrad(dy, w, ctx.pad_mode) if need[0] else None
        dw = conv7_wgrad(x, dy, ctx.pad_mode) if need[1] else None
        db = (dy.to(torch.float32).sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
              if ctx.bias_dtype is not None and need[2] else None)
        return dx, dw, db, None


def conv7_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
              pad_mode: str = "reflect") -> torch.Tensor:
    """``conv7`` with a gradient: K4f forward, K4d and K4w backward."""
    return _Conv7.apply(x, w, bias, pad_mode)
