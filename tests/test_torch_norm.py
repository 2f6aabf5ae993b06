"""uig_torch.kernels.norm against the JAX instance norm (the Pallas kernel
in interpret mode, and flax InstanceNorm). The port runs on the CPU, where
the wrapper takes its plain version. fp32 both sides; atol 1e-5 covers sums
taken in another order over at most 144 pixels. The backward (the plain
version of the norm-backward kernel, from the statistics the forward kept,
and the autograd function that pairs it with the forward) is held against
``norm_pallas._bwd_impl`` and ``jax.vjp`` of ``instance_norm_pallas``: dx
within 1e-5, dgamma and dbeta (sums over the batch too) within 1e-5 of
their largest value. The statistics the port's forwards keep (mean and
1/sqrt(var + eps)) match those of JAX's fused conv+IN forward within 1e-6
(sums of 144 values in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uig.kernels.convin_pallas import _convin_fwd_impl
from uig.kernels.norm_pallas import _bwd_impl, instance_norm_pallas
from uig.models.layers import InstanceNorm as JaxInstanceNorm
from uig_torch.kernels import (instance_norm, instance_norm_act,
                               instance_norm_bwd)
from uig_torch.kernels.convin import _conv3_in_fwd
from uig_torch.kernels.norm import _instance_norm_fwd
from uig_torch.models.layers import InstanceNorm

ATOL = 1e-5
STATS_ATOL = 1e-6


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


def _backward_matches(x, g, b, dy, stats, relu):
    """The port's backward from ``stats`` against the Pallas backward and
    ``jax.vjp`` of ``instance_norm_pallas``; returns (dx, dg, db)."""
    tx, tg, tb, tdy = map(torch.from_numpy, (x, g, b, dy))
    dx, dg, db = (t.numpy() for t in instance_norm_bwd(tx, tg, tb, tdy, stats,
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
    return dx, dg, db


@pytest.mark.parametrize("c", [8, 128])
@pytest.mark.parametrize("relu", [False, True])
def test_backward_matches_pallas_bwd_and_vjp(c, relu):
    x, g, b = _inputs(c, seed=3)
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    tx, tg, tb, tdy = map(torch.from_numpy, (x, g, b, dy))
    stats = _instance_norm_fwd(tx, tg, tb, 1e-5, relu)[1]
    assert stats.shape == (2, 2, c) and stats.dtype == torch.float32
    dx, dg, db = _backward_matches(x, g, b, dy, stats, relu)
    # the autograd function, which saves the forward's statistics, gives the
    # same gradients
    ins = [t.clone().requires_grad_(True) for t in (tx, tg, tb)]
    y = instance_norm_act(*ins, relu=relu)
    grads = torch.autograd.grad(y, ins, tdy)
    for u, v in zip(grads, (dx, dg, db)):
        np.testing.assert_array_equal(u.numpy(), v)


def test_statistics_match_the_fused_forward_and_drive_the_backward():
    """The mean and 1/sqrt(var + eps) of the port's conv+IN forward and of
    its norm forward on the same conv output, against JAX's
    ``_convin_fwd_impl`` (interpret mode); then the backward from them."""
    rng = np.random.default_rng(7)
    # the shape of _inputs(8): the backward's JAX functions are compiled
    x = rng.standard_normal((2, 12, 12, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 8)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(8) * 0.1).astype(np.float32)
    g = (rng.standard_normal(8) * 0.2 + 1.0).astype(np.float32)
    be = (rng.standard_normal(8) * 0.2).astype(np.float32)
    _, yc, mean, rstd = _convin_fwd_impl(
        *map(jnp.asarray, (x, w.reshape(72, 8), b, g, be)), relu=True,
        eps=1e-5, reflect=True)
    want = np.stack([np.asarray(mean), np.asarray(rstd)])
    _, _, conv_stats = _conv3_in_fwd(*map(torch.from_numpy, (x, w, b, g, be)),
                                     True, 1e-5, "reflect")
    yc = np.array(yc)
    tyc, tg, tbe = map(torch.from_numpy, (yc, g, be))
    _, norm_stats = _instance_norm_fwd(tyc, tg, tbe, 1e-5, True)
    for stats in (conv_stats, norm_stats):
        np.testing.assert_allclose(stats.numpy(), want, rtol=0,
                                   atol=STATS_ATOL)
    dy = rng.standard_normal(yc.shape).astype(np.float32)
    _backward_matches(yc, g, be, dy, norm_stats, True)


def test_backward_checks_shapes():
    x = torch.zeros(1, 4, 4, 8)
    stats = torch.zeros(2, 1, 8)
    with pytest.raises(ValueError, match="one \\(B, H, W, C\\) shape"):
        instance_norm_bwd(x, torch.ones(8), torch.zeros(8), x[:, :2], stats)
    with pytest.raises(ValueError, match="stats has shape"):
        instance_norm_bwd(x, torch.ones(8), torch.zeros(8), x, stats[:, :, :4])
