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
the exact bf16 products in fp32 and round once, in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uig.kernels.conv_pallas import conv7_s2d
from uig_torch.kernels import conv7, conv7_act, conv7_dgrad, conv7_wgrad
from uig_torch.models.layers import PadConv

ATOL = 1e-4


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_conv7_matches_conv7_s2d(pad_mode):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 64, 3)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(3) * 0.1).astype(np.float32)
    got = conv7(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                pad_mode).numpy()
    ref = np.asarray(conv7_s2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               pad_mode=pad_mode))
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
    path. In fp32 every Cin routes."""
    conv = PadConv(cin, 3, 7, pad=3, dtype=torch.bfloat16)
    assert conv.routes_to_conv7() is routed
    assert PadConv(cin, 3, 7, pad=3).routes_to_conv7()
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
        lambda *a: conv7_s2d(*a, pad_mode=pad_mode), x, w, b)[1](dy))
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


def _conv7_mma_order(x, w, b, pad_mode):
    """conv7 in bf16 as csrc/conv7_tc.cu sums it: Z[oy, p, (kx, f)] = sum
    over ky of x[row(oy + ky - 3), p] @ w[ky] as (Cin, 7 Cout); then y[oy,
    ox, f] = sum over kx, in order, of Z[oy, col(ox + kx - 3), (kx, f)],
    plus the bias, rounded once to bf16. row() and col() mirror in reflect
    mode; in zeros mode a tap outside the plane adds nothing."""
    nb, h, wd, cin = x.shape
    cout = w.shape[3]
    xf, wf = x.float(), w.float()

    def source(n):  # the source index of padded positions -3 .. n + 2
        i = torch.arange(-3, n + 3)
        if pad_mode == "reflect":
            i = torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))
        return i.clamp(0, n - 1), ((i >= 0) & (i < n)).float()

    rows, row_ok = source(h)
    z = torch.zeros(nb, h, wd, 7 * cout)
    for ky in range(7):
        a = xf[:, rows[ky:ky + h]] * row_ok[ky:ky + h].view(1, h, 1, 1)
        z = z + a @ wf[ky].permute(1, 0, 2).reshape(cin, 7 * cout)
    cols, col_ok = source(wd)
    s = torch.zeros(nb, h, wd, cout)
    for kx in range(7):
        zk = z[:, :, cols[kx:kx + wd], kx * cout:(kx + 1) * cout]
        s = s + zk * col_ok[kx:kx + wd].view(1, 1, wd, 1)
    return (s + b.float()).to(torch.bfloat16)


@pytest.mark.parametrize("pad_mode,cout", [("reflect", 3), ("zeros", 1)])
def test_conv7_bf16_mma_order_matches_jax(pad_mode, cout):
    """At a width that fills no m16 tile (20), Cout 3 and 1, each pad
    mode."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 20, 32)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 32, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    args = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tx, tw, tb)]
    # compiled whole with excess precision off: XLA on the CPU then rounds
    # to bf16 where the program says
    want = np.asarray(jax.jit(
        lambda *a: conv7_s2d(*a, pad_mode=pad_mode)).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(
                *args).astype(jnp.float32))
    got = _conv7_mma_order(tx, tw, tb, pad_mode).float().numpy()
    assert got.shape == want.shape == (2, 12, 20, cout)
    m = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(m)) - 7)
    assert np.abs(got.astype(np.float64) - want).max() <= ulp
