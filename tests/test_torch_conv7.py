"""uig_torch.kernels.conv against the JAX 7x7 head conv (``conv7_s2d``, the
Pallas kernel in interpret mode), cin 64 -> 3 at 16^2. The port runs on the
CPU, where the wrapper takes its plain version. fp32; atol 1e-4 as the JAX
package's own conv7_s2d test (49*64-term sums in another order).

The backward (the plain versions of the dgrad and wgrad kernels, and the
autograd function over the forward) is held against ``jax.vjp`` of
``conv7_s2d`` at cin 32 (``4 * cin % 128 == 0``), 16^2, both pad modes: dx
within 1e-4; dw and db (sums over 2 * 16^2 pixels) within 1e-5 of their
largest value.

The bf16 CUDA forward (``csrc/conv7_tc.cu``) sums in its own order: for
each output row, Z = the 7 row taps' products summed over (ky, c) with the
7 column taps folded into N, then the column shift-sum over kx in order,
the bias, and one rounding. ``test_conv7_bf16_mma_order_matches_jax``
emulates that order in torch and holds it to JAX's ``conv7_s2d`` in bf16
within 1 bf16 ulp of its largest value, 2^(floor(log2 M) - 7): both sum
the exact bf16 products in fp32 and round once, in another order. The bf16
weight gradient on wgmma (``csrc/conv7_wgrad_tc.cu``, kx folded into N,
fp32 sums over tiles of 32 rows of a 128-column strip, one rounding) is
emulated the same way and held to 1 bf16 ulp of the largest dw of JAX's
bf16 VJP, from the same program (one compile a case). The fp32 CUDA
forward (``csrc/conv7_tf32.cu``, the same fold in the three-term TF32
split with partials of one k8 step) is emulated and held within ATOL of
JAX's fp32 ``conv7_s2d`` at the plain version's shape (Cin 64, the
path's), its error from float64 at most twice the plain version's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uig.kernels.conv_pallas import conv7_s2d
from uig_torch.kernels import (conv7, conv7_act, conv7_dgrad,
                               conv7_reference, conv7_wgrad)
from uig_torch.kernels.conv import MAX_CIN_FP32
from uig_torch.models.layers import PadConv

ATOL = 1e-4
# XLA's CPU backend without LLVM's optimization passes: the JAX references
# compile in about a third of the time, to the same bits (checked for each
# program of this file against the default level).
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


@functools.lru_cache(maxsize=None)
def _fp32_case(pad_mode):
    """The head at (2, 16, 16, 64) -> 3: x, w and b from seed 2, and JAX's
    ``conv7_s2d`` of them in fp32, shared by the plain version's test and
    the fp32 kernel's order."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 64, 3)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(3) * 0.1).astype(np.float32)
    ref = np.asarray(conv7_s2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               pad_mode=pad_mode))
    return (x, w, b), ref


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_conv7_matches_conv7_s2d(pad_mode):
    (x, w, b), ref = _fp32_case(pad_mode)
    got = conv7(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                pad_mode).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_padconv_routes_only_the_head_to_conv7():
    assert PadConv(64, 3, 7, pad=3).routes_to_conv7()
    assert not PadConv(3, 64, 7, pad=3).routes_to_conv7()  # the stem
    assert not PadConv(64, 128, 3, stride=2, pad=1,
                       pad_mode="zeros").routes_to_conv7()


@pytest.mark.parametrize("cin,routed", [(64, True), (256, True), (6, False),
                                        (260, False)])
def test_padconv_routes_bf16_heads_the_kernel_takes(cin, routed):
    """In bf16 the head routes to conv7 only where its kernel takes Cin (a
    multiple of 4, at most MAX_CIN_BF16); the others take the ordinary conv
    path. In fp32 every Cin up to MAX_CIN_FP32 routes (the split kernel's
    B and source rows in shared memory), 6 included."""
    conv = PadConv(cin, 3, 7, pad=3, dtype=torch.bfloat16)
    assert conv.routes_to_conv7() is routed
    assert PadConv(cin, 3, 7, pad=3).routes_to_conv7() is (cin <= MAX_CIN_FP32)
    y = conv(torch.randn(1, 8, 8, cin))
    assert y.shape == (1, 8, 8, 3) and y.dtype == torch.bfloat16


def test_conv7_checks():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        conv7(x, torch.zeros(3, 3, 4, 3), None)
    with pytest.raises(ValueError, match="pad_mode"):
        conv7(x, torch.zeros(7, 7, 4, 3), None, "circular")


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_backward_matches_jax_vjp(pad_mode):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 32, 3)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(3) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    # one compile of the whole vjp (op by op, it compiles every op)
    vjp = jax.jit(lambda x, w, b, dy: jax.vjp(
        lambda *a: conv7_s2d(*a, pad_mode=pad_mode), x, w, b)[1](dy)).lower(
            x, w, b, dy).compile(compiler_options=_FAST_COMPILE)
    wdx, wdw, wdb = (np.asarray(v) for v in vjp(x, w, b, dy))
    tx, tw, tb, tdy = map(torch.from_numpy, (x, w, b, dy))
    dx = conv7_dgrad(tdy, tw, pad_mode).numpy()
    dw = conv7_wgrad(tx, tdy, pad_mode).numpy()
    np.testing.assert_allclose(dx, wdx, atol=ATOL)
    np.testing.assert_allclose(dw, wdw, rtol=0,
                               atol=1e-5 * np.abs(wdw).max())
    ins = [t.clone().requires_grad_(True) for t in (tx, tw, tb)]
    got = torch.autograd.grad(conv7_act(*ins, pad_mode), ins, tdy)
    np.testing.assert_array_equal(got[0].numpy(), dx)
    np.testing.assert_array_equal(got[1].numpy(), dw)
    np.testing.assert_allclose(got[2].numpy(), wdb, rtol=0,
                               atol=1e-5 * np.abs(wdb).max())


def _source(n, pad_mode):
    """The source index of padded positions -3 .. n + 2 (reflect mirrors)
    and whether it lies in the plane (zeros mode adds nothing outside)."""
    i = torch.arange(-3, n + 3)
    if pad_mode == "reflect":
        i = torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))
    return i.clamp(0, n - 1), ((i >= 0) & (i < n)).float()


@functools.lru_cache(maxsize=None)
def _head_case(pad_mode, cout):
    """The head at (2, 12, 20, 32) -> cout in bf16: x, w, b and dy from seed
    11 (fp32; the program and the emulations round them to bf16), and
    JAX's answers from one program compiled once with excess precision off
    (XLA on the CPU then rounds to bf16 where the program says):
    ``conv7_s2d`` and the weight gradient of its VJP for dy (bf16, as JAX's
    weight cast rounds the cotangent)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 20, 32)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 32, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, 12, 20, cout)).astype(np.float32)

    def program(x, w, b, dy):
        xb, wb, bb, dyb = (a.astype(jnp.bfloat16) for a in (x, w, b, dy))
        y16, vjp = jax.vjp(
            lambda wv: conv7_s2d(xb, wv, bb, pad_mode=pad_mode), wb)
        return y16, vjp(dyb)[0]

    args = [jnp.asarray(a) for a in (x, w, b, dy)]
    outs = jax.jit(program).lower(*args).compile(compiler_options={
        **_FAST_COMPILE, "xla_allow_excess_precision": False})(*args)
    return (x, w, b, dy), [np.asarray(o.astype(jnp.float32)) for o in outs]


def _bf16_ulp_err(got, want):
    """The largest difference in bf16 ulps of want's largest magnitude,
    2^(floor(log2 M) - 7)."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return np.abs(got.astype(np.float64) - want).max() / ulp


def _conv7_mma_order(x, w, b, pad_mode):
    """conv7 in bf16 as csrc/conv7_tc.cu sums it: Z[oy, p, (kx, f)] = sum
    over ky of x[row(oy + ky - 3), p] @ w[ky] as (Cin, 7 Cout); then y[oy,
    ox, f] = sum over kx, in order, of Z[oy, col(ox + kx - 3), (kx, f)],
    plus the bias, rounded once to bf16. row() and col() mirror in reflect
    mode; in zeros mode a tap outside the plane adds nothing."""
    nb, h, wd, cin = x.shape
    cout = w.shape[3]
    xf, wf = x.float(), w.float()
    rows, row_ok = _source(h, pad_mode)
    z = torch.zeros(nb, h, wd, 7 * cout)
    for ky in range(7):
        a = xf[:, rows[ky:ky + h]] * row_ok[ky:ky + h].view(1, h, 1, 1)
        z = z + a @ wf[ky].permute(1, 0, 2).reshape(cin, 7 * cout)
    cols, col_ok = _source(wd, pad_mode)
    s = torch.zeros(nb, h, wd, cout)
    for kx in range(7):
        zk = z[:, :, cols[kx:kx + wd], kx * cout:(kx + 1) * cout]
        s = s + zk * col_ok[kx:kx + wd].view(1, 1, wd, 1)
    return (s + b.float()).to(torch.bfloat16)


@pytest.mark.parametrize("pad_mode,cout", [("reflect", 3), ("zeros", 1)])
def test_conv7_bf16_mma_order_matches_jax(pad_mode, cout):
    """At a width that fills no m16 tile (20), Cout 3 and 1, each pad
    mode."""
    (x, w, b, _), (want, _) = _head_case(pad_mode, cout)
    tx, tw, tb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    got = _conv7_mma_order(tx, tw, tb, pad_mode).float().numpy()
    assert got.shape == want.shape == (2, 12, 20, cout)
    assert _bf16_ulp_err(got, want) <= 1.0


def _tf32_split(a):
    """fp32 -> (hi, lo) as csrc/tf32.cuh splits it: hi = rna_tf32(a), lo =
    rna_tf32(a - hi), each rounded to the nearest TF32 value, ties away
    from zero."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(a)
    return hi, rna(a - hi)


def _conv7_tf32_order(x, w, b, pad_mode):
    """conv7 in fp32 as csrc/conv7_tf32.cu sums it: Z[oy, p, (kx, f)] =
    the partials of one k8 step (8 channels of one row tap: lo_x hi_w +
    hi_x lo_w + hi_x hi_w, summed here in float64 and rounded to fp32, as
    the tensor core's fresh accumulator does) added in fp32 in the order
    (ky, channels); then y[oy, ox, f] = the sum over kx, in order, of Z[oy,
    col(ox + kx - 3), (kx, f)], plus the bias, in fp32."""
    nb, h, wd, cin = x.shape
    cout = w.shape[3]
    xs, ws = _tf32_split(x), _tf32_split(w)
    rows, row_ok = _source(h, pad_mode)
    z = torch.zeros(nb, h, wd, 7 * cout)
    for ky in range(7):
        mask = row_ok[ky:ky + h].view(1, h, 1, 1)
        ah, al = (a[:, rows[ky:ky + h]].double() * mask for a in xs)
        bh, bl = (m[ky].permute(1, 0, 2).reshape(cin, 7 * cout).double()
                  for m in ws)
        for c0 in range(0, cin, 8):
            c = slice(c0, c0 + 8)
            part = al[..., c] @ bh[c] + ah[..., c] @ bl[c] + ah[..., c] @ bh[c]
            z = z + part.float()
    cols, col_ok = _source(wd, pad_mode)
    y = torch.zeros(nb, h, wd, cout)
    for kx in range(7):
        zk = z[:, :, cols[kx:kx + wd], kx * cout:(kx + 1) * cout]
        y = y + zk * col_ok[kx:kx + wd].view(1, 1, wd, 1)
    return y + b


def _conv7_fp64(x, w, b, pad_mode):
    xn = x.double().permute(0, 3, 1, 2)
    wt = w.double().permute(3, 2, 0, 1)
    if pad_mode == "reflect":
        y = F.conv2d(F.pad(xn, (3, 3, 3, 3), mode="reflect"), wt, b.double())
    else:
        y = F.conv2d(xn, wt, b.double(), padding=3)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_conv7_tf32_order_matches_jax(pad_mode):
    """K4f's fp32 order (the fold, the split with one-k8-step partials, the
    shift-sum) within ATOL of JAX's fp32 ``conv7_s2d``, and its error from
    float64 at most twice the plain version's (fp32 on the CPU), at the
    path's Cin of 64 (eight k8 partials a tap), on the plain version's
    test's inputs and JAX answer."""
    (x, w, b), want = _fp32_case(pad_mode)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    got = _conv7_tf32_order(tx, tw, tb, pad_mode)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    exact = _conv7_fp64(tx, tw, tb, pad_mode)
    err = [(y.double() - exact).abs().max().item()
           for y in (got, conv7_reference(tx, tw, tb, pad_mode))]
    assert err[0] <= 2.0 * err[1], err


def _conv7_wgrad_tc_order(x, dy, pad_mode, tile=(32, 128)):
    """dw in bf16 as csrc/conv7_wgrad_tc.cu sums it: for each tile (an
    image's 32 output rows of a 128-column strip [x0, x1)), D_ky (Cin, 7
    Cout) += A_ky(oy)^T B(oy) over the tile's rows in order, in fp32, with
    A_ky(oy)[q] = x[row(oy + ky - 3), col(x0 + q - 3)] over the strip's
    padded columns q < x1 - x0 + 6 and B(oy)[q, (kx, f)] = dy[oy, x0 + q -
    kx, f] where x0 + q - kx lies in the strip, else 0; the tiles' sums
    (one a block where the blocks are as many as the tiles, as here) added
    in order, rounded once to bf16."""
    nb, h, wd, cin = x.shape
    cout = dy.shape[3]
    xf, dyf = x.float(), dy.float()
    rows, row_ok = _source(h, pad_mode)
    cols, col_ok = _source(wd, pad_mode)
    dw = torch.zeros(7, cin, 7 * cout)
    for bi in range(nb):
        for r0 in range(0, h, tile[0]):
            for x0 in range(0, wd, tile[1]):
                x1 = min(wd, x0 + tile[1])
                nq = x1 - x0 + 6
                a_all = xf[bi][:, cols[x0:x0 + nq]] * col_ok[x0:x0 + nq, None]
                d = torch.zeros(7, cin, 7 * cout)
                for oy in range(r0, min(h, r0 + tile[0])):
                    bm = torch.zeros(nq, 7 * cout)
                    for kx in range(7):
                        bm[kx:kx + x1 - x0, kx * cout:(kx + 1) * cout] = \
                            dyf[bi, oy, x0:x1]
                    for ky in range(7):
                        if row_ok[oy + ky]:
                            d[ky] = d[ky] + a_all[rows[oy + ky]].T @ bm
                dw = dw + d
    return dw.reshape(7, cin, 7, cout).permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("pad_mode,cout", [("reflect", 3), ("zeros", 1)])
def test_conv7_bf16_wgrad_order_matches_jax(pad_mode, cout):
    """K4w's bf16 order on the tensor cores (the fold of kx into N, tiles
    of rows summed in fp32, rounded once) within 1 bf16 ulp of the largest
    dw of JAX's bf16 VJP of ``conv7_s2d``."""
    (x, _, _, dy), (_, want) = _head_case(pad_mode, cout)
    tx, tdy = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy))
    got = _conv7_wgrad_tc_order(tx, tdy, pad_mode).float().numpy()
    assert got.shape == want.shape == (7, 7, 32, cout)
    assert _bf16_ulp_err(got, want) <= 1.0
