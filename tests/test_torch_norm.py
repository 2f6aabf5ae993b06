"""uig_torch.kernels.norm against the JAX instance norm (the Pallas kernel
in interpret mode, and flax InstanceNorm). The port runs on the CPU, where
the wrapper takes its plain version. fp32 both sides; atol 1e-5 covers sums
taken in another order over at most 144 pixels. The backward (the plain
version of the norm-backward kernel, and the autograd function that pairs
it with the forward) is held against ``norm_pallas._bwd_impl`` and
``jax.vjp`` of ``instance_norm_pallas``: dx within 1e-5, dgamma and dbeta
(sums over the batch too) within 1e-5 of their largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uig.kernels.norm_pallas import _bwd_impl, instance_norm_pallas
from uig.models.layers import InstanceNorm as JaxInstanceNorm
from uig_torch.kernels import (instance_norm, instance_norm_act,
                               instance_norm_bwd)
from uig_torch.models.layers import InstanceNorm

ATOL = 1e-5


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 12, 12, c)) * 2 + 0.5).astype(np.float32)
    g = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    b = (rng.standard_normal(c) * 0.2).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("c", [8, 128])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_matches_pallas_and_flax(c, relu):
    x, g, b = _inputs(c)
    got = instance_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b), relu=relu).numpy()
    pallas = np.asarray(instance_norm_pallas(jnp.asarray(x), jnp.asarray(g),
                                             jnp.asarray(b), relu=relu))
    flax_y = JaxInstanceNorm().apply(
        {"params": {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}},
        jnp.asarray(x))
    if relu:
        flax_y = jax.nn.relu(flax_y)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(flax_y), atol=ATOL)


def test_module_fuses_relu():
    x, g, b = _inputs(8, seed=1)
    m = InstanceNorm(8)
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(g))
        m.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_array_equal(m(xt, relu=True).numpy(),
                                      torch.relu(m(xt)).numpy())


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 4, 4, 8), device="meta")
    g = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        instance_norm(x, g, g)
    with pytest.raises(ValueError, match="several devices"):
        instance_norm(torch.zeros(1, 4, 4, 8), g, g)
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        instance_norm(torch.zeros(4, 4, 8), torch.ones(8), torch.zeros(8))


def _param_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("c", [8, 128])
@pytest.mark.parametrize("relu", [False, True])
def test_backward_matches_pallas_bwd_and_vjp(c, relu):
    x, g, b = _inputs(c, seed=3)
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    tx, tg, tb, tdy = map(torch.from_numpy, (x, g, b, dy))
    dx, dg, db = (t.numpy() for t in instance_norm_bwd(tx, tg, tb, tdy,
                                                       relu=relu))
    jx, jg, jb, jdy = map(jnp.asarray, (x, g, b, dy))
    kdx, kdg, kdb = _bwd_impl(jx, jg, jb, jdy, eps=1e-5, relu=relu)
    _, vjp = jax.vjp(lambda *a: instance_norm_pallas(*a, relu=relu),
                     jx, jg, jb)
    vdx, vdg, vdb = vjp(jdy)
    for want_dx, want_dg, want_db in ((kdx, kdg, kdb), (vdx, vdg, vdb)):
        np.testing.assert_allclose(dx, np.asarray(want_dx), atol=ATOL)
        _param_close(dg, np.asarray(want_dg))
        _param_close(db, np.asarray(want_db))
    # the autograd function gives the same gradients
    ins = [t.clone().requires_grad_(True) for t in (tx, tg, tb)]
    y = instance_norm_act(*ins, relu=relu)
    grads = torch.autograd.grad(y, ins, tdy)
    for u, v in zip(grads, (dx, dg, db)):
        np.testing.assert_array_equal(u.numpy(), v)


def test_backward_checks_shapes():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="one \\(B, H, W, C\\) shape"):
        instance_norm_bwd(x, torch.ones(8), torch.zeros(8), x[:, :2])
