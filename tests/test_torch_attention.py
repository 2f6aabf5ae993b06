"""The port's attention (``uig_torch.kernels.attention``) against the JAX
package's ``attention(impl="pallas")``, which on the CPU runs the Pallas
forward and backward kernels in interpret mode. The port runs its plain
versions (CPU tensors): the forward, the row log-sum-exp it keeps as the
backward's residual, and dq/dk/dv of the autograd function.

Shapes: N = 256 is one q block of the Pallas kernel (block_q 256), N = 512
two, and N = 40 a ragged N that the Pallas kernel takes by halving its
block to 8. Inputs are numpy normals from a seed.

Tolerances, fp32 on both sides with sums in another order: the output
within 1e-5 of its largest value; each gradient within 1e-5 of its largest
value; the log-sum-exp within 1e-5 of float64's.

The CUDA kernels multiply in the three-term TF32 split on the tensor cores;
``test_tf32x3_split_matches_pallas`` emulates that arithmetic in torch on
the CPU and holds it to the same tolerance against the Pallas kernels.

bf16 (the VQGAN training step's dtype): the same inputs rounded to bf16
through the Pallas kernels in bf16 (fp32 math on widened inputs, o and the
gradients rounded to bf16 once) against the port's plain versions in bf16
and against the kernels' bf16 arithmetic emulated in torch (a bf16 operand
is exact in TF32, so the terms of its lo, exact zeros, are dropped). Both
sides round fp32 values that agree to about 1e-6 of their size, so an
output at a rounding boundary lands one bf16 ulp apart: each output within
one bf16 ulp of its largest magnitude, 2^(floor(log2 max) - 7). The kernels
take delta = rowsum(dO o O) from the forward's unrounded O;
``test_delta_from_rounded_o_fails`` holds that choice on inputs where dP and
delta nearly cancel (v nearly the same for every key), where delta from
the bf16 O lands many ulps off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uig.kernels.attention_pallas import attention as jax_attention
from uig_torch.kernels.attention import (attention, attention_bwd,
                                         attention_fwd)

REL = 1e-5
SHAPES = [(2, 256, 32), (1, 512, 32), (2, 40, 16)]
BF16_CASES = [(2, 256, 32), (2, 40, 16), "near_cancel"]
NEAR_CANCEL = (2, 64, 32)
ULPS = 1.0


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _pallas_fwd_bwd(q, k, v, do):
    o, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, impl="pallas"),
                     q, k, v)
    return (o, *vjp(do))


@pytest.fixture(scope="module")
def jax_runs():
    """{shape: (q, k, v, do, o, dq, dk, dv)} from the Pallas kernels, the
    forward and its VJP under one ``jax.jit`` a shape, compiled with XLA's
    backend at optimization level 0 (a fraction of the compile time)."""
    out = {}
    for i, shape in enumerate(SHAPES):
        q, k, v, do = _inputs(shape, i)
        args = tuple(map(jnp.asarray, (q, k, v, do)))
        res = jax.jit(_pallas_fwd_bwd).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})(*args)
        out[shape] = (q, k, v, do, *map(np.asarray, res))
    return out


def _close(got, want, what):
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= REL * np.abs(want).max(), f"{what}: {err}"


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_pallas(jax_runs, shape):
    q, k, v, _, o, *_ = jax_runs[shape]
    got, lse, o32 = attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == shape and lse.shape == shape[:2]
    assert o32 is got  # fp32: the output is the backward's residual
    _close(got.numpy(), o, "o")
    logits = np.einsum("bnd,bmd->bnm", q.astype(np.float64),
                       k.astype(np.float64)) / np.sqrt(shape[-1])
    m = logits.max(-1, keepdims=True)
    ref = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    assert np.abs(lse.numpy() - ref).max() <= 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gradients_match_pallas(jax_runs, shape):
    q, k, v, do, o, *want = jax_runs[shape]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(attention(*ts), ts, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), w, name)
    # the wrapper itself, from the forward's residuals
    _, lse, o32 = attention_fwd(*(t.detach() for t in ts))
    direct = attention_bwd(*(t.detach() for t in ts), o32, lse,
                           torch.from_numpy(do))
    for g, d in zip(got, direct):
        assert torch.equal(g, d)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 to the nearest TF32 value (ties away from zero, as
    ``cvt.rna.tf32.f32``): add half of the 13 dropped bits' weight to the
    magnitude bits, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: each operand as hi = tf32(x) and
    lo = tf32(x - hi), the terms lo hi, hi lo, hi hi summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi = _tf32(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    rel = ((hi + _tf32(r - hi)).double() - r.double()).abs() / r.abs().double()
    assert rel.max() <= 2.0 ** -22


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tf32x3_split_matches_pallas(jax_runs, shape):
    """The forward's two products and the backward's five in the split,
    with the softmax, delta and the epilogues in fp32 as the kernels take
    them, against the Pallas kernels' outputs at REL."""
    q, k, v, do, o_want, *want = jax_runs[shape]
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    scale = 1.0 / shape[-1] ** 0.5
    s = _mm3(q, k.transpose(1, 2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _mm3(p, v) / l
    lse = m + torch.log(l)
    _close(o.numpy(), o_want, "o")
    # the backward from the forward's residuals: S^T and dP^T key-major
    pt = torch.exp(_mm3(k, q.transpose(1, 2)) * scale - lse.transpose(1, 2))
    dpt = _mm3(v, do.transpose(1, 2))
    delta = (do * o).sum(-1)[:, None, :]
    dst = pt * (dpt - delta)
    dv = _mm3(pt, do)
    dk = _mm3(dst, q) * scale
    dq = _mm3(dst.transpose(1, 2), k) * scale
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _close(g.numpy(), w, name)


def test_shape_checks():
    q = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="one \\(B, N, D\\) shape"):
        attention_fwd(q, q, torch.zeros(1, 8, 8))
    with pytest.raises(ValueError):
        attention_fwd(torch.zeros(8, 4), torch.zeros(8, 4), torch.zeros(8, 4))


# ------------------------------------------------------------------ bf16 --


def _bf16(a: np.ndarray) -> np.ndarray:
    """fp32 numpy rounded to bf16 (nearest even), widened back."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _bf16_inputs(case, seed):
    """q, k, v, do as bf16 values (fp32 numpy). "near_cancel": v = c + 2^-6
    noise, one c per batch element, so that dP_j = dO v_j and delta =
    sum_j P_j dP_j nearly cancel in dS = P o (dP - delta)."""
    if case != "near_cancel":
        return [_bf16(a) for a in _inputs(case, seed)]
    rng = np.random.default_rng(seed)
    b, n, d = NEAR_CANCEL
    q, k, do = (rng.standard_normal(NEAR_CANCEL) for _ in range(3))
    v = rng.standard_normal((b, 1, d)) + 2.0 ** -6 * rng.standard_normal(
        NEAR_CANCEL)
    return [_bf16(a.astype(np.float32)) for a in (q, k, v, do)]


@pytest.fixture(scope="module")
def jax_bf16_runs():
    """{case: (q, k, v, do, o, dq, dk, dv)}, fp32 numpy of bf16 values,
    from the Pallas kernels in bf16, compiled as ``jax_runs`` and with
    excess precision off (the program rounds to bf16 where it says, as
    its ops run one by one)."""
    out = {}
    for i, case in enumerate(BF16_CASES):
        q, k, v, do = _bf16_inputs(case, 10 + i)
        args = tuple(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
        o, *grads = jax.jit(_pallas_fwd_bwd).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0,
                              "xla_allow_excess_precision": False})(*args)
        assert o.dtype == jnp.bfloat16 and grads[1].dtype == jnp.bfloat16
        out[case] = (q, k, v, do, *(np.asarray(t, np.float32)
                                    for t in (o, *grads)))
    return out


def _ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _ulp_err(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / _ulp(np.abs(want).max()))


def _close_ulp(got, want, what):
    err = _ulp_err(got, want)
    assert err <= ULPS, f"{what}: {err} bf16 ulps"


def _t16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_bf16_forward_matches_pallas(jax_bf16_runs, case):
    q, k, v, _, o, *_ = jax_bf16_runs[case]
    got, lse, o32 = attention_fwd(*_t16(q, k, v))
    assert got.dtype == torch.bfloat16
    assert lse.dtype == o32.dtype == torch.float32
    _close_ulp(got, o, "o")
    assert torch.equal(got, o32.to(torch.bfloat16))  # rounded once


@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_bf16_gradients_match_pallas(jax_bf16_runs, case):
    q, k, v, do, _, *want = jax_bf16_runs[case]
    ts = [t.requires_grad_(True) for t in _t16(q, k, v)]
    dot, = _t16(do)
    got = torch.autograd.grad(attention(*ts), ts, dot)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        _close_ulp(g, w, name)
    _, lse, o32 = attention_fwd(*(t.detach() for t in ts))
    direct = attention_bwd(*(t.detach() for t in ts), o32, lse, dot)
    for g, d in zip(got, direct):
        assert torch.equal(g, d)


def test_bf16_operands_are_exact_in_tf32():
    """A bf16 value widened to fp32 is its own TF32 high part, and its low
    part is 0: the kernels' bf16 operands enter their products as hi
    alone."""
    x = torch.from_numpy(_bf16(np.random.default_rng(1).standard_normal(
        4096).astype(np.float32) * 10))
    hi = _tf32(x)
    assert torch.equal(hi, x)
    assert not _tf32(x - hi).any()


def _mm(a: torch.Tensor, b: torch.Tensor, split_a: bool,
        split_b: bool) -> torch.Tensor:
    """``_mm3`` as the bf16 kernels form it: an operand that TF32 holds
    exactly (bf16) enters as hi alone, and the terms of its lo are left
    out, in the split's order."""
    ah, bh = _tf32(a), _tf32(b)
    out = None
    for keep, term in ((split_a, lambda: _tf32(a - ah) @ bh),
                       (split_b, lambda: ah @ _tf32(b - bh))):
        if keep:
            out = term() if out is None else out + term()
    return ah @ bh if out is None else out + ah @ bh


def _bf16_kernel_math(q, k, v, do, delta_from_rounded_o=False):
    """(o, dq, dk, dv) by the bf16 kernels' arithmetic, rounded to bf16:
    Q K^T and dO V^T one product, P V, P^T dO, dS^T Q and dS K two; P and
    dS fp32; delta = rowsum(dO o O) from the fp32 O (or, to show why, from
    O rounded to bf16). Each product is also held bit-equal to the fp32
    split's three terms on the same widened values."""
    scale = 1.0 / q.shape[-1] ** 0.5

    def mm(a, b, split_a):
        got = _mm(a, b, split_a, False)
        assert torch.equal(got, _mm3(a, b))
        return got

    s = mm(q, k.transpose(1, 2), False) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o32 = mm(p, v, True) / l
    lse = m + torch.log(l)
    pt = torch.exp(mm(k, q.transpose(1, 2), False) * scale
                   - lse.transpose(1, 2))
    dpt = mm(v, do.transpose(1, 2), False)
    o_d = o32.to(torch.bfloat16).float() if delta_from_rounded_o else o32
    dst = pt * (dpt - (do * o_d).sum(-1)[:, None, :])
    dv = mm(pt, do, True)
    dk = mm(dst, q, True) * scale
    dq = mm(dst.transpose(1, 2), k, True) * scale
    return tuple(t.to(torch.bfloat16) for t in (o32, dq, dk, dv))


@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_bf16_split_matches_pallas(jax_bf16_runs, case):
    q, k, v, do, *want = jax_bf16_runs[case]
    got = _bf16_kernel_math(*(torch.from_numpy(a) for a in (q, k, v, do)))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        _close_ulp(g, w, name)


def test_delta_from_rounded_o_fails(jax_bf16_runs):
    """Where dP and delta nearly cancel, delta taken from the bf16 O moves
    dq and dk many ulps; from the fp32 O they stay within one."""
    q, k, v, do, _, *want = jax_bf16_runs["near_cancel"]
    ins = [torch.from_numpy(a) for a in (q, k, v, do)]
    good = _bf16_kernel_math(*ins)[1:]
    bad = _bf16_kernel_math(*ins, delta_from_rounded_o=True)[1:]
    for name, g, b, w in zip(("dq", "dk"), good, bad, want):
        _close_ulp(g, w, name)
        assert _ulp_err(b, w) > 4 * ULPS, name
