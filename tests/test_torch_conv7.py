"""uig_torch.kernels.conv against the JAX 7x7 head conv (``conv7_s2d``, the
Pallas kernel in interpret mode), cin 64 -> 3 at 16^2. The port runs on the
CPU, where the wrapper takes its plain version. fp32; atol 1e-4 as the JAX
package's own conv7_s2d test (49*64-term sums in another order).

The backward (the plain versions of the dgrad and wgrad kernels, and the
autograd function over the forward) is held against ``jax.vjp`` of
``conv7_s2d`` at cin 32 (``4 * cin % 128 == 0``), 16^2, both pad modes: dx
within 1e-4; dw and db (sums over 2 * 16^2 pixels) within 1e-5 of their
largest value."""

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
