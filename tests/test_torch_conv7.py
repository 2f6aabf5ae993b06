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

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uig.kernels.conv_pallas import conv7_s2d
from uig_torch.kernels import (conv7, conv7_act, conv7_dgrad,
                               conv7_dgrad_reference, conv7_reference,
                               conv7_wgrad, conv7_wgrad_reference)
from uig_torch.kernels import conv as conv_mod
from uig_torch.kernels.conv import MAX_CIN_FP32
from uig_torch.kernels.reflect import reflect_fold
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


@pytest.mark.parametrize("wrapper", ["conv7", "conv7_dgrad", "conv7_wgrad"])
def test_card_cin_checks_follow_takes_cin(wrapper, monkeypatch):
    """Each wrapper's card path takes exactly the Cin that ``takes_cin``
    admits (the Cin that ``PadConv`` routes to the head), for Cin 1..120 in
    both dtypes, through the one check all three share (``_check_card``):
    the backward refuses no head that the forward took. The card is stood
    in for: CPU tensors pass as card operands and the launch is recorded,
    not made."""
    launched, checked = [], []
    real = conv_mod._check_card
    monkeypatch.setattr(conv_mod, "on_cpu", lambda name, *t: False)
    monkeypatch.setattr(conv_mod._build, "launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(conv_mod, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(conv_mod, "_check_card",
                        lambda *a: (checked.append(a[3:]), real(*a)))
    fn = getattr(conv_mod, wrapper)
    monkeypatch.setattr(fn, "launches", fn.launches)
    for dtype in (torch.float32, torch.bfloat16):
        for cin in range(1, 121):
            x = torch.zeros(1, 8, 8, cin, dtype=dtype)
            w = torch.zeros(7, 7, cin, 3, dtype=dtype)
            dy = torch.zeros(1, 8, 8, 3, dtype=dtype)
            args = {"conv7": (x, w, None), "conv7_dgrad": (dy, w),
                    "conv7_wgrad": (x, dy)}[wrapper]
            n = len(launched)
            if conv_mod.takes_cin(cin, dtype):
                fn(*args)
                assert len(launched) == n + 1, (cin, dtype)
            else:
                with pytest.raises(ValueError, match="takes Cin"):
                    fn(*args)
                assert len(launched) == n
            assert checked[-1] == (cin, 3, "reflect", dtype)


def test_conv7_checks():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        conv7(x, torch.zeros(3, 3, 4, 3), None)
    with pytest.raises(ValueError, match="pad_mode"):
        conv7(x, torch.zeros(7, 7, 4, 3), None, "circular")


@functools.lru_cache(maxsize=None)
def _bwd_case(pad_mode):
    """The head's backward at (2, 16, 16, 32) -> 3: x, w, b and dy from seed
    7, and JAX's fp32 VJP of ``conv7_s2d`` for dy (dx, dw, db), one compile
    of the whole VJP (op by op, it compiles every op), shared by the plain
    versions' test and the fp32 kernels' orders."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 32, 3)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(3) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    vjp = jax.jit(lambda x, w, b, dy: jax.vjp(
        lambda *a: conv7_s2d(*a, pad_mode=pad_mode), x, w, b)[1](dy)).lower(
            x, w, b, dy).compile(compiler_options=_FAST_COMPILE)
    return (x, w, b, dy), tuple(np.asarray(v) for v in vjp(x, w, b, dy))


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_backward_matches_jax_vjp(pad_mode):
    (x, w, b, dy), (wdx, wdw, wdb) = _bwd_case(pad_mode)
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


def _dgrad_fp64(dy, w, pad_mode):
    """conv7's input gradient in float64, the reflect ring folded onto its
    sources in float64."""
    nb, h, wd, _ = dy.shape
    wt, dyn = w.double().permute(3, 2, 0, 1), dy.double().permute(0, 3, 1, 2)
    if pad_mode == "zeros":
        return torch.nn.grad.conv2d_input((nb, w.shape[2], h, wd), wt, dyn,
                                          padding=3).permute(0, 2, 3, 1)
    dxp = torch.nn.grad.conv2d_input((nb, w.shape[2], h + 6, wd + 6), wt,
                                     dyn)
    return reflect_fold(dxp.permute(0, 2, 3, 1), 3)


def _wgrad_fp64(x, dy, pad_mode):
    """conv7's weight gradient in float64, against the padded x."""
    xn, dyn = x.double().permute(0, 3, 1, 2), dy.double().permute(0, 3, 1, 2)
    shape = (dy.shape[3], x.shape[3], 7, 7)
    if pad_mode == "zeros":
        dw = torch.nn.grad.conv2d_weight(xn, shape, dyn, padding=3)
    else:
        dw = torch.nn.grad.conv2d_weight(F.pad(xn, (3, 3, 3, 3),
                                               mode="reflect"), shape, dyn)
    return dw.permute(2, 3, 1, 0)


def _ring_src(src, i, n):
    """The padded row (or column) whose window pass ``src`` adds to dx row
    i of a plane of n, for a tensor of rows: 0 main, 1 the near ring, 2 the
    far ring; -1 where there is none."""
    if src == 0:
        return i + 3
    if src == 1:
        return torch.where((i >= 1) & (i <= 3), 3 - i, -1)
    return torch.where((i >= n - 4) & (i <= n - 2), 2 * n + 1 - i, -1)


def _conv7_dgrad_tf32_order(dy, w, pad_mode, depth=1):
    """dx in fp32 as csrc/conv7_bwd_tf32.cu sums it: the row of A at padded
    position (P, Q) is the window dy[P - 6 + r, Q - 6 + u, o] (zero outside
    the plane), K in the order k = r L + u Cout + o (L = 7 Cout) padded to
    whole k8 steps, B[k, c] = w[6 - r, 6 - u, c, o]; partials of ``depth``
    k8 steps (lo hi + hi lo + hi hi, summed here in float64 and rounded to
    fp32, as the tensor core's fresh accumulator does) added in fp32 in K
    order, for the main pass (P, Q) = (i + 3, j + 3) and then, in reflect
    mode, each ring pass (row source, column source) in order, for the
    pixels that have it."""
    nb, h, wd, cout = dy.shape
    cin = w.shape[2]
    k = 49 * cout
    kp = -(-k // 8) * 8
    b = F.pad(w.flip(0, 1).permute(0, 1, 3, 2).reshape(k, cin),
              (0, 0, 0, kp - k))
    dyp = F.pad(dy.permute(0, 3, 1, 2), (6, 6, 6, 6)).permute(0, 2, 3, 1)
    a = dyp.unfold(1, 7, 1).unfold(2, 7, 1).permute(0, 1, 2, 4, 5, 3)
    a = F.pad(a.reshape(nb, h + 6, wd + 6, k), (0, kp - k))
    ah, al = (v.double() for v in _tf32_split(a))
    bh, bl = (v.double() for v in _tf32_split(b))
    parts = []
    for k0 in range(0, kp, 8 * depth):
        s = slice(k0, k0 + 8 * depth)
        parts.append((al[..., s] @ bh[s] + ah[..., s] @ bl[s]
                      + ah[..., s] @ bh[s]).float())
    rows = torch.arange(h)[:, None].expand(h, wd)
    cols = torch.arange(wd)[None, :].expand(h, wd)
    passes = [(rs, cs) for rs in range(3) for cs in range(3)]
    dx = torch.zeros(nb, h, wd, cin)
    for rs, cs in passes if pad_mode == "reflect" else [(0, 0)]:
        p, q = _ring_src(rs, rows, h), _ring_src(cs, cols, wd)
        ok = ((p >= 0) & (q >= 0))[None, :, :, None]
        for part in parts:
            dx = dx + part[:, p.clamp(min=0), q.clamp(min=0)] * ok
    return dx


def _conv7_wgrad_tf32_order(x, dy, pad_mode, depth=0):
    """dw in fp32 as csrc/conv7_wgrad_tf32.cu sums it: for each tile (an
    image's 16 output rows of a strip [x0, x1) of 58 columns, 26 at Cout
    4), each output row oy in order and each ky, the partial A_ky(oy)^T
    B(oy) over the strip's padded columns q < 8 ceil((x1 - x0 + 6) / 8) (in
    partials of ``depth`` k8 steps, 0 all of them; each partial's three
    terms summed here in float64 and rounded to fp32) added to the tile's
    fp32 sum, with A_ky(oy)[q] = x[row(oy + ky - 3), col(x0 + q - 3)] (zero
    past the strip's padded columns; in zeros mode a row outside the plane
    adds nothing) and B(oy)[q, (kx, f)] = dy[oy, x0 + q - kx, f] where x0 +
    q - kx lies in the strip; the tiles' sums (one a block where the blocks
    are as many as the tiles, as here) added in order."""
    nb, h, wd, cin = x.shape
    cout = dy.shape[3]
    tw = 26 if cout == 4 else 58
    rows, row_ok = _source(h, pad_mode)
    cols, col_ok = _source(wd, pad_mode)
    xs, ds = _tf32_split(x), _tf32_split(dy)
    dw = torch.zeros(7, cin, 7 * cout)
    for bi in range(nb):
        for r0 in range(0, h, 16):
            for x0 in range(0, wd, tw):
                x1 = min(wd, x0 + tw)
                nq = x1 - x0 + 6
                kq = -(-nq // 8) * 8
                step = 8 * depth if depth else kq
                a = [F.pad((v[bi][:, cols[x0:x0 + nq]]
                            * col_ok[x0:x0 + nq, None]).double(),
                           (0, 0, 0, kq - nq)) for v in xs]
                d = torch.zeros(7, cin, 7 * cout)
                for oy in range(r0, min(h, r0 + 16)):
                    bm = [torch.zeros(kq, 7 * cout, dtype=torch.float64)
                          for _ in ds]
                    for m, v in zip(bm, ds):
                        for kx in range(7):
                            m[kx:kx + x1 - x0, kx * cout:(kx + 1) * cout] = \
                                v[bi, oy, x0:x1].double()
                    for ky in range(7):
                        if not row_ok[oy + ky]:
                            continue
                        ah, al = (v[rows[oy + ky]] for v in a)
                        for q0 in range(0, kq, step):
                            s = slice(q0, q0 + step)
                            d[ky] = d[ky] + (al[s].T @ bm[0][s]
                                             + ah[s].T @ bm[1][s]
                                             + ah[s].T @ bm[0][s]).float()
                dw = dw + d
    return dw.reshape(7, cin, 7, cout).permute(0, 2, 1, 3)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_conv7_tf32_dgrad_order_matches_jax(pad_mode):
    """K4d's fp32 order on the tensor cores (the split with one-k8-step
    partials over the window's K order, the ring passes in order) within
    ATOL of the dx of JAX's fp32 VJP of ``conv7_s2d``, and its error from
    float64 at most twice the plain version's (fp32 on the CPU), on the VJP
    test's inputs and JAX answer."""
    (_, w, _, dy), (want, _, _) = _bwd_case(pad_mode)
    tw, tdy = torch.from_numpy(w), torch.from_numpy(dy)
    got = _conv7_dgrad_tf32_order(tdy, tw, pad_mode)
    assert got.shape == want.shape == (2, 16, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    exact = _dgrad_fp64(tdy, tw, pad_mode)
    err = [(v.double() - exact).abs().max().item()
           for v in (got, conv7_dgrad_reference(tdy, tw, pad_mode))]
    assert err[0] <= 2.0 * err[1], err


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_conv7_tf32_wgrad_order_matches_jax(pad_mode):
    """K4w's fp32 order on the tensor cores (the taps folded into N, the
    split with a strip row's k8 steps a partial, rows and tiles in order) within
    1e-5 of the largest dw of JAX's fp32 VJP of ``conv7_s2d``, and its
    error from float64 at most twice the plain version's, on the VJP test's
    inputs and JAX answer."""
    (x, _, _, dy), (_, want, _) = _bwd_case(pad_mode)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    got = _conv7_wgrad_tf32_order(tx, tdy, pad_mode)
    assert got.shape == want.shape == (7, 7, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    exact = _wgrad_fp64(tx, tdy, pad_mode)
    err = [(v.double() - exact).abs().max().item()
           for v in (got, conv7_wgrad_reference(tx, tdy, pad_mode))]
    assert err[0] <= 2.0 * err[1], err
