"""The 7x7 stride-1 pad-3 conv + bias for few output channels: the CUDA
kernel in ``csrc/conv7.cu`` and its plain PyTorch version.

Replaces the JAX package's ``kernels/conv_pallas.py`` ``conv7_s2d`` (through
``conv_core5`` -> ``_conv5_impl`` -> ``_conv5_kernel``). Same linear map; the
TPU's space-to-depth view is a lane trick and is not carried over. x is NHWC,
w is HWIO (7, 7, Cin, Cout) with Cout <= 4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uig_torch.kernels import _build
from uig_torch.kernels._check import cuda_operand, on_cpu

MAX_COUT = 4


def conv7_reference(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor | None,
                    pad_mode: str = "reflect") -> torch.Tensor:
    xn = x.permute(0, 3, 1, 2)
    wt = w.permute(3, 2, 0, 1)
    if pad_mode == "reflect":
        y = F.conv2d(F.pad(xn, (3, 3, 3, 3), mode="reflect"), wt, bias)
    elif pad_mode == "zeros":
        y = F.conv2d(xn, wt, bias, padding=3)
    else:
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")
    return y.permute(0, 2, 3, 1).contiguous()


def conv7(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
          pad_mode: str = "reflect") -> torch.Tensor:
    """pad-3 7x7 stride-1 conv + bias. x: (B, H, W, Cin); w: (7, 7, Cin,
    Cout), Cout <= 4. Output (B, H, W, Cout)."""
    if x.dim() != 4 or tuple(w.shape[:2]) != (7, 7) or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv7: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    cout = w.shape[3]
    if bias is None:
        bias = torch.zeros((cout,), device=x.device, dtype=torch.float32)
    if on_cpu("conv7", x, w, bias):
        return conv7_reference(x, w, bias, pad_mode)
    if pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")
    if cout > MAX_COUT:
        raise ValueError(f"conv7: Cout={cout} > {MAX_COUT}")
    nb, h, wd, cin = x.shape
    if pad_mode == "reflect" and (h < 4 or wd < 4):
        raise ValueError("conv7: reflect padding needs H, W >= 4")
    cuda_operand("conv7", "x", x)
    cuda_operand("conv7", "w", w)
    cuda_operand("conv7", "bias", bias, (cout,))
    y = torch.empty((nb, h, wd, cout), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _build.launch("uig_conv7_fwd", x, w, bias, y, nb, h, wd, cin, cout,
                      pad_mode == "reflect")
    conv7.launches += 1
    return y


conv7.launches = 0
