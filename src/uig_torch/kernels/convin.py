"""Fused 3x3 conv + bias + instance norm (+ReLU): the CUDA kernels behind
``csrc/conv3_in.cu`` and their plain PyTorch version.

Replaces the JAX package's ``kernels/convin_pallas.py`` forward
(``_convin_fwd_impl`` -> ``_convin_kernel``): a pad-1 3x3 stride-1 conv
(reflect or zeros) + bias, fp32 channel moments of the conv output, then
normalize + affine (+ReLU). Same signature as the JAX ``conv3_in_act``;
x is NHWC and w is HWIO (3, 3, C, F), which the kernel reads as the (9C, F)
matrix of an implicit GEMM. x and w are fp32 or bf16 (one type); b, g and
be fp32. In bf16 the conv sums in fp32, ``acc + b`` is rounded once to bf16
for the conv output, and the moments come from those rounded values, as in
the Pallas kernel. Both types run the conv on the tensor cores
(``wgmma``), with the entry point in ``conv3_in.cu``: fp32 in the
three-term TF32 split (``conv3_in_tf32.cu``: each operand as a hi and a lo
TF32 part, three products summed in fp32, which keeps fp32's order of
error; single-pass TF32 is not used), bf16 with exact products into fp32
accumulators (``conv3_in_tc.cu``). Both write the same per-tile moment
partials and share the finalize, which keeps the statistics (mean and
1/sqrt(var + eps) per example and channel) for the backward.

The backward is the composition of ``convin_pallas.py``'s ``bwd``, which is
XLA in JAX and no Pallas kernel: the instance norm backward (K2b,
``kernels/norm.py``) on the saved conv output, from the forward's saved
statistics as there, gives its gradient, the conv bias gradient is that
gradient's sum, and the conv's weight and input gradients are library convs (cuDNN on the card) against the padded plane
the forward read, with the reflect ring folded by ``kernels/reflect.py``.
In bf16 the norm backward's gradient is rounded to bf16 before them, and
they run in bf16, as JAX transposes its bf16 conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uig_torch.kernels import _build
from uig_torch.kernels._check import cuda_operand, on_cpu, storage_type
from uig_torch.kernels.norm import (_instance_norm_fwd, instance_norm_bwd,
                                    instance_norm_reference)
from uig_torch.kernels.reflect import reflect_fold

_BM = 128  # output pixels per conv tile, of one image (both designs)


def _check_pad_mode(pad_mode: str) -> None:
    if pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")


def conv3_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    pad_mode: str) -> torch.Tensor:
    """The conv half alone: NHWC x, HWIO w, pad 1, stride 1, + bias, in
    fp32 from the widened inputs, rounded once to x's type."""
    xn = x.to(torch.float32).permute(0, 3, 1, 2)
    wt = w.to(torch.float32).permute(3, 2, 0, 1)
    b = b.to(torch.float32)
    if pad_mode == "reflect":
        y = F.conv2d(F.pad(xn, (1, 1, 1, 1), mode="reflect"), wt, b)
    else:
        y = F.conv2d(xn, wt, b, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3_in_act_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           g: torch.Tensor, be: torch.Tensor, *, relu: bool,
                           eps: float = 1e-5,
                           pad_mode: str = "reflect") -> torch.Tensor:
    _check_pad_mode(pad_mode)
    return instance_norm_reference(conv3_reference(x, w, b, pad_mode), g, be,
                                   eps, relu)


def _conv3_in_fwd(x, w, b, g, be, relu, eps, pad_mode):
    """(y, y_conv, stats): the normalized output, the conv output it came
    from, and the norm's statistics (2, B, F) fp32."""
    if on_cpu("conv3_in_act", x, w, b, g, be):
        yconv = conv3_reference(x, w, b, pad_mode)
        y, stats = _instance_norm_fwd(yconv, g, be, eps, relu)
        return y, yconv, stats
    nb, h, wd, c = x.shape
    f = w.shape[3]
    if c % 4 or f % 4:
        raise ValueError(f"conv3_in_act: C={c} and F={f} must be multiples of 4")
    if pad_mode == "reflect" and (h < 2 or wd < 2):
        raise ValueError("conv3_in_act: reflect padding needs H, W >= 2")
    name = "conv3_in_act"
    dt = storage_type(name, "x", x)
    cuda_operand(name, "w", w, dtypes=(dt,))
    for what, t in (("b", b), ("g", g), ("be", be)):
        cuda_operand(name, what, t, (f,))
    tiles = -(-(h * wd) // _BM)
    yconv = torch.empty((nb, h, wd, f), device=x.device, dtype=dt)
    y = torch.empty_like(yconv)
    part = torch.empty((2, nb, tiles, f), device=x.device, dtype=torch.float32)
    # scale, shift, then the statistics
    ss = torch.empty((4, nb, f), device=x.device, dtype=torch.float32)
    # fp32: the weight's hi and lo TF32 planes, K-major, 9 taps of C
    # channels rounded up to 32
    wt = None if dt == torch.bfloat16 else torch.empty(
        (2, f, 9 * -(-c // 32) * 32), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _build.launch("uig_conv3_in_fwd", x, w, wt, b, g, be, yconv, y, part,
                      ss, nb, h, wd, c, f, pad_mode == "reflect", bool(relu),
                      float(eps), dt == torch.bfloat16)
    conv3_in_act.launches += 1
    return y, yconv, ss[2:]


def conv3_dgrad(dyc: torch.Tensor, w: torch.Tensor,
                pad_mode: str) -> torch.Tensor:
    """Input gradient of the pad-1 3x3 conv (library dgrad): onto the
    (H+2, W+2) padded plane, then the reflect ring folded (reflect) or the
    zero ring dropped (zeros)."""
    nb, h, wd, _ = dyc.shape
    wt = w.permute(3, 2, 0, 1)
    dyn = dyc.permute(0, 3, 1, 2)
    cin = w.shape[2]
    if pad_mode == "reflect":
        dxp = torch.nn.grad.conv2d_input((nb, cin, h + 2, wd + 2), wt, dyn)
        return reflect_fold(dxp.permute(0, 2, 3, 1), 1).contiguous()
    dx = torch.nn.grad.conv2d_input((nb, cin, h, wd), wt, dyn, padding=1)
    return dx.permute(0, 2, 3, 1).contiguous()


def conv3_wgrad(x: torch.Tensor, dyc: torch.Tensor,
                pad_mode: str) -> torch.Tensor:
    """Weight gradient of the pad-1 3x3 conv (library wgrad) against the
    padded plane the forward read; HWIO (3, 3, C, F)."""
    xn = x.permute(0, 3, 1, 2)
    dyn = dyc.permute(0, 3, 1, 2)
    shape = (dyc.shape[3], x.shape[3], 3, 3)
    if pad_mode == "reflect":
        dw = torch.nn.grad.conv2d_weight(
            F.pad(xn, (1, 1, 1, 1), mode="reflect"), shape, dyn)
    else:
        dw = torch.nn.grad.conv2d_weight(xn, shape, dyn, padding=1)
    return dw.permute(2, 3, 1, 0).contiguous()


class _Conv3InAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, g, be, relu, eps, pad_mode):
        y, yconv, stats = _conv3_in_fwd(x, w, b, g, be, relu, eps, pad_mode)
        ctx.save_for_backward(x, w, g, be, yconv, stats)
        ctx.relu, ctx.pad_mode = relu, pad_mode
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, g, be, yconv, stats = ctx.saved_tensors
        dyc, dg, dbe = instance_norm_bwd(yconv, g, be, dy.contiguous(), stats,
                                         ctx.relu)
        db = dyc.to(torch.float32).sum(dim=(0, 1, 2))
        need = ctx.needs_input_grad
        dx = conv3_dgrad(dyc, w, ctx.pad_mode) if need[0] else None
        dw = conv3_wgrad(x, dyc, ctx.pad_mode) if need[1] else None
        return dx, dw, db, dg, dbe, None, None, None


def conv3_in_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 g: torch.Tensor, be: torch.Tensor, *, relu: bool,
                 eps: float = 1e-5, pad_mode: str = "reflect") -> torch.Tensor:
    """Pad-1 3x3 stride-1 conv + bias + InstanceNorm(scale=g, bias=be)
    (+ReLU), with a gradient. x: (B, H, W, C); w: (3, 3, C, F), both fp32
    or both bf16; b, g, be: (F,) fp32. Output (B, H, W, F) in x's type."""
    _check_pad_mode(pad_mode)
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3_in_act: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    return _Conv3InAct.apply(x, w, b, g, be, bool(relu), float(eps), pad_mode)


conv3_in_act.launches = 0
