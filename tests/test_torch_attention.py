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


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def jax_runs():
    """{shape: (q, k, v, do, o, dq, dk, dv)} from the Pallas kernels."""
    out = {}
    for i, shape in enumerate(SHAPES):
        q, k, v, do = _inputs(shape, i)
        o, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, impl="pallas"),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(do))
        out[shape] = (q, k, v, do, np.asarray(o), *map(np.asarray, grads))
    return out


def _close(got, want, what):
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= REL * np.abs(want).max(), f"{what}: {err}"


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_pallas(jax_runs, shape):
    q, k, v, _, o, *_ = jax_runs[shape]
    got, lse = attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == shape and lse.shape == shape[:2]
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
    o_t, lse = attention_fwd(*(t.detach() for t in ts))
    direct = attention_bwd(*(t.detach() for t in ts), o_t, lse,
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
