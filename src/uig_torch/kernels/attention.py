"""Single-head attention: the forward CUDA kernel (K5f) and the backward
(K5b) in ``csrc/attention.cu``, their plain PyTorch versions, and
``attention``, the autograd function that the VQGAN ``AttnBlock`` calls.

Replaces the JAX package's ``kernels/attention_pallas.py``
(``_attention_fwd_impl`` -> ``_attn_kernel``, ``_attention_bwd_impl`` ->
``_attn_bwd_kernel``). q, k, v are (B, N, D), fp32 or bf16; the softmax is
taken in fp32 over scale * q k^T with scale = 1/sqrt(D), stabilised by the
row max. In bf16 the inputs are widened and every product, the softmax and
every sum run in fp32, as in the Pallas kernels; o and dq, dk, dv are
rounded to bf16 once. The forward also returns the row log-sum-exp (B, N)
and the fp32 o: the port keeps both as the backward's residuals, beside
q, k, v (JAX keeps q, k, v and recomputes the row max). In bf16 the fp32 o
is the unrounded one, so that the backward's delta = rowsum(dO o O) is
taken from the values JAX's rowsum(P o dP) sums.

The kernels multiply on the tensor cores in the three-term TF32 split
(each fp32 operand as a rounded TF32 high part plus a TF32 low part, three
products summed in fp32), which keeps fp32's order of error: the card
tests and ``chip_smoke.py`` hold them within 1e-5 of each output's largest
value against the plain versions. A bf16 operand is exact in TF32 and
enters as its high part alone. The plain versions compute in fp32.
"""

from __future__ import annotations

import torch

from uig_torch.kernels import _build
from uig_torch.kernels._check import cuda_operand, on_cpu, storage_type

MAX_D = 512  # the kernels keep a 16 x D / 2 accumulator a warp in registers


def _scale(d: int) -> float:
    return 1.0 / float(d) ** 0.5


def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.bmm(q.to(torch.float32),
                     k.to(torch.float32).transpose(1, 2)) * _scale(q.shape[-1])


def _reference_fwd(q, k, v):
    """(o in fp32, lse): the forward before o is rounded to q's dtype."""
    logits = _logits(q, k)
    p = torch.softmax(logits, dim=-1)
    return torch.bmm(p, v.to(torch.float32)), torch.logsumexp(logits, -1)


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v in fp32, rounded once to q's dtype: the
    JAX package's ``attention_xla`` and its Pallas forward."""
    return _reference_fwd(q, k, v)[0].to(q.dtype)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor):
    """(dq, dk, dv) for the output gradient ``do``, by the JAX backward
    kernel's arithmetic: P recomputed, dS = P o (dP - rowsum(P o dP))."""
    scale = _scale(q.shape[-1])
    q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
    do32 = do.to(torch.float32)
    p = torch.softmax(_logits(q32, k32), dim=-1)
    dp = torch.bmm(do32, v32.transpose(1, 2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = scale * torch.bmm(ds, k32)
    dk = scale * torch.bmm(ds.transpose(1, 2), q32)
    dv = torch.bmm(p.transpose(1, 2), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(name: str, *ts: torch.Tensor) -> tuple[int, int, int]:
    shape = tuple(ts[0].shape)
    if len(shape) != 3 or any(tuple(t.shape) != shape for t in ts):
        raise ValueError(f"{name}: q, k, v (and do) must share one (B, N, D) "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    return shape


def _check_cuda(name: str, n: int, d: int, q: torch.Tensor,
                tensors: dict) -> torch.dtype:
    """The storage type of ``q`` (fp32 or bf16), after checking the shape
    and the operands: ``tensors`` {name: (tensor, shape or None, fp32)},
    each of q's type unless it is marked fp32. A 16-byte copy holds 4 fp32
    or 8 bf16 values of a row, so D is a multiple of 4, or 8 in bf16."""
    dt = storage_type(name, "q", q)
    mult = 4 if dt == torch.float32 else 8
    if d % mult or not 4 <= d <= MAX_D or n < 1:
        raise ValueError(f"{name}: needs N >= 1 and D a multiple of {mult} "
                         f"in [4, {MAX_D}] for {str(dt)[6:]}, got N={n}, "
                         f"D={d}")
    for what, (t, shape, f32) in tensors.items():
        cuda_operand(name, what, t, shape,
                     dtypes=(torch.float32,) if f32 else (dt,))
    return dt


def _key_splits(dev: torch.device, b: int, n: int) -> int:
    """2 where one 64-row block a q tile would fill at most half the SMs
    and there are two key tiles to share, else 1."""
    tiles = -(-n // 64)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return 2 if tiles >= 2 and 2 * b * tiles <= sms else 1


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(o, lse, o32): o = softmax(q k^T / sqrt(D)) v, (B, N, D) in q's
    dtype; the row log-sum-exp of the scaled logits, (B, N); and o in fp32,
    the backward's residual (o itself in fp32, the unrounded o in bf16). On
    the card the keys run in one range or, where ``_key_splits`` says, in
    two, a kernel block each, merged in a fixed order."""
    b, n, d = _check_qkv("attention_fwd", q, k, v)
    if on_cpu("attention_fwd", q, k, v):
        o32, lse = _reference_fwd(q, k, v)
        return o32.to(q.dtype), lse, o32
    dt = _check_cuda("attention_fwd", n, d, q,
                     {"k": (k, None, False), "v": (v, None, False)})
    splits = _key_splits(q.device, b, n)
    o = torch.empty_like(q)
    o32 = o if dt == torch.float32 else torch.empty_like(q, dtype=torch.float32)
    lse = torch.empty((b, n), device=q.device, dtype=torch.float32)
    # the two ranges' partial O and lse
    part = (torch.empty(2 * b * n * (d + 1), device=q.device,
                        dtype=torch.float32) if splits == 2 else None)
    with torch.cuda.device(q.device):
        _build.launch("uig_attention_fwd", q, k, v, o, lse, part,
                      None if o32 is o else o32, b, n, d, _scale(d), splits,
                      dt == torch.bfloat16)
    attention_fwd.launches += 1
    return o, lse, o32


attention_fwd.launches = 0


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o32: torch.Tensor, lse: torch.Tensor, do: torch.Tensor):
    """(dq, dk, dv) of ``attention_fwd(q, k, v)`` for the output gradient
    ``do``, in q's dtype; ``lse`` and ``o32`` (fp32) are that call's
    residuals. On the card the kernels keep P^T and dS^T in a scratch of
    2 B Np^2 fp32, Np = N rounded up to 128: 64 MiB for vqgan512's step
    (8, 1024), 256 MiB for vaegan256's (32, 1024) on one card (both domains
    of 16 at its 32² grid), 1 GiB at (8, 4096), a 64² grid."""
    b, n, d = _check_qkv("attention_bwd", q, k, v, o32, do)
    if on_cpu("attention_bwd", q, k, v, o32, lse, do):
        return attention_bwd_reference(q, k, v, do)
    dt = _check_cuda("attention_bwd", n, d, q,
                     {"k": (k, None, False), "v": (v, None, False),
                      "o32": (o32, None, True), "do": (do, None, False),
                      "lse": (lse, (b, n), True)})
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, n), device=q.device, dtype=torch.float32)
    # dS^T and P^T, key-major, N rounded up to a multiple of 128 on both
    # sides (the scores kernel's tiles)
    n_pad = -(-n // 128) * 128
    ds = torch.empty((2, b, n_pad, n_pad), device=q.device,
                     dtype=torch.float32)
    with torch.cuda.device(q.device):
        _build.launch("uig_attention_bwd", q, k, v, o32, lse, do, delta, ds,
                      dq, dk, dv, b, n, d, _scale(d), dt == torch.bfloat16)
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse, o32 = attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o32, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        return attention_bwd(q, k, v, o32, lse, do.contiguous())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attention_fwd``'s output with a gradient: K5f forward, K5b
    backward."""
    return _Attention.apply(q, k, v)
