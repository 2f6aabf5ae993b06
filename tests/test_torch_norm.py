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
(sums of 144 values in another order).

The forward kernel's plan (``fwd_plan``) and its static tasks, mirrored
here from ``csrc/instance_norm_fwd.cu``, are checked in pure Python: every
pixel is covered once by a moment task and once by an apply task of the
same block, a resident run fits the ring beside the next group's first
stages (at most two groups in flight), and the plan fits the kernel at the
path's shapes. The kernel's summation order is emulated in numpy (fp32, the
squares' sums as fused multiply-adds): within 1e-5 of the Pallas kernel
and at most twice the plain version's error from float64."""

import functools
import itertools

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
from uig_torch.kernels.norm import _instance_norm_fwd, fwd_plan
from uig_torch.models.layers import InstanceNorm

ATOL = 1e-5
STATS_ATOL = 1e-6


def _compiled(fn, *args):
    """``fn(*args)`` under one ``jax.jit``, compiled with XLA's backend at
    optimization level 0 (the Pallas kernels in interpret mode compile in
    a fraction of the time)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@functools.lru_cache(maxsize=None)
def _pallas_fwd(c, relu):
    """The Pallas forward on ``_inputs(c)``, computed once a case."""
    return np.asarray(_compiled(
        lambda *a: instance_norm_pallas(*a, relu=relu),
        *map(jnp.asarray, _inputs(c))))


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 12, 12, c)) * 2 + 0.5).astype(np.float32)
    g = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    b = (rng.standard_normal(c) * 0.2).astype(np.float32)
    return x, g, b


# C = 6: no lane packing on the TPU side (P = 1), scalar channels on the card
@pytest.mark.parametrize("c", [8, 128, 6])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_matches_pallas_and_flax(c, relu):
    x, g, b = _inputs(c)
    got = instance_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b), relu=relu).numpy()
    pallas = _pallas_fwd(c, relu)
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
    def both(x, g, b, dy):
        _, vjp = jax.vjp(lambda *a: instance_norm_pallas(*a, relu=relu),
                         x, g, b)
        return _bwd_impl(x, g, b, dy, eps=1e-5, relu=relu), vjp(dy)

    (kdx, kdg, kdb), (vdx, vdg, vdb) = _compiled(
        both, *map(jnp.asarray, (x, g, b, dy)))
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
    _, yc, mean, rstd = _compiled(
        lambda *a: _convin_fwd_impl(*a, relu=True, eps=1e-5, reflect=True),
        *map(jnp.asarray, (x, w.reshape(72, 8), b, g, be)))
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


# ----------------------------------------------- the forward kernel's plan --

SMS = 132  # an H100 SXM
# the instance norms of a cyclegan256_dp step at batch 8, (batch, H, C):
# the generator's at 2B and B, the discriminator's
PATH = [(nb, h, c) for nb in (16, 8) for h, c in (
    (256, 64), (128, 128), (64, 256), (64, 128), (32, 256), (31, 512))]


def _check_plan(b, hw, c, isz, plan):
    """The plan fits the kernel, and its tasks cover every pixel once:
    task t of group u is chunk t % chunks of image u * group + t /
    chunks, taken by task block t % blocks (csrc/instance_norm_fwd.cu);
    its moments and its apply cover the same pixels."""
    row = c * isz
    assert plan == fwd_plan(b, hw, c, isz, SMS)
    width = row // 16 if plan.vec else min(c, 256)
    assert plan.lanes >= 1 and plan.lanes * width <= 256
    assert 2 * plan.lanes * (c if plan.vec else width) <= 4096
    pieces = c // 4 if c % 4 == 0 else c
    assert plan.fin_lanes >= 1 and plan.fin_lanes * min(pieces, 256) <= 256
    if plan.vec:
        assert row % 16 == 0 and plan.ring == 12
        assert plan.stage_rows % plan.lanes == 0
        assert plan.lanes <= plan.stage_rows and plan.stage_rows * row <= 16384
    assert (plan.chunks - 1) * plan.rows < hw <= plan.chunks * plan.rows
    assert 1 <= plan.reducers <= min(4, b) and plan.grid <= SMS
    blocks = plan.grid - plan.reducers
    groups = -(-b // plan.group)
    seen = np.zeros((b, hw), np.int64)
    taken = np.zeros((groups, blocks), np.int64)
    for u in range(groups):
        images = min((u + 1) * plan.group, b) - u * plan.group
        for t in range(images * plan.chunks):
            i, k = u * plan.group + t // plan.chunks, t % plan.chunks
            seen[i, k * plan.rows:(k + 1) * plan.rows] += 1
            taken[u, t % blocks] += 1
    assert (seen == 1).all()
    if plan.resident:
        # one task a block a group; a run in at most 9 of the 12 stages, so
        # that the next group's first stages arrive while it waits
        assert plan.vec and taken.max() == 1
        assert -(-plan.rows // plan.stage_rows) <= 9


@pytest.mark.parametrize("isz", [4, 2], ids=["fp32", "bf16"])
def test_fwd_plan_fits_the_path(isz):
    """At the path's widths every plan stages 16-byte columns and keeps
    each run in the ring from its moments to its apply, so x is read from
    device memory once; every SM but the reducers' takes a task."""
    for nb, h, c in PATH:
        plan = fwd_plan(nb, h * h, c, isz, SMS)
        assert plan.vec and plan.resident
        _check_plan(nb, h * h, c, isz, plan)


@pytest.mark.parametrize("b,hw,c,isz", [
    (3, 221, 36, 4), (3, 221, 36, 2), (1, 5, 4, 4), (1, 5, 4, 2),
    (1, 1024, 1, 4), (2, 100, 3, 2), (5, 37, 6, 4), (4, 777, 10, 2),
    (2, 10, 3000, 4), (7, 4096, 64, 4), (33, 2048, 96, 2),
    (1, 262144, 64, 4), (2, 600 * 600, 32, 2)])
def test_fwd_plan_covers_every_pixel(b, hw, c, isz):
    """Ragged shapes: scalar channels (C * isz % 16 != 0, or more than 256
    16-byte columns), runs cut at the last pixels, a last group of fewer
    images, and images too large to stay in the ring (staged twice)."""
    plan = fwd_plan(b, hw, c, isz, SMS)
    _check_plan(b, hw, c, isz, plan)
    if hw * c * isz > SMS * 9 * 16384:
        assert not plan.resident


def _fma32(a, b, c):
    """fp32 a * b + c rounded once (float64 holds the exact product)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _emulate_fwd(x, g, be, eps, relu, plan):
    """The forward kernel's arithmetic in numpy: chunk pixel q of image b
    summed by lane q % lanes in pixel order (x, and x * x as a fused
    multiply-add), the lanes added in order into the chunk's partial; the
    finalize's lane f adding chunks f per .. (f + 1) per - 1 in order (per
    = ceil(chunks / fin_lanes)), the lanes added in order; then the fp32 statistics and y = x scale + shift
    as the kernel computes them. Returns (y, mean, rstd)."""
    b, h, w, c = x.shape
    hw = h * w
    xf = x.reshape(b, hw, c)
    lanes, fl = plan.lanes, plan.fin_lanes
    part = np.zeros((b, plan.chunks, 2, c), np.float32)
    for i, k in itertools.product(range(b), range(plan.chunks)):
        run = xf[i, k * plan.rows:(k + 1) * plan.rows]
        acc = np.zeros((lanes, 2, c), np.float32)
        for q, v in enumerate(run):
            acc[q % lanes, 0] += v
            acc[q % lanes, 1] = _fma32(v, v, acc[q % lanes, 1])
        for ln in range(lanes):
            part[i, k] += acc[ln]
    y = np.empty_like(xf)
    mean = np.empty((b, c), np.float32)
    rstd = np.empty((b, c), np.float32)
    n = np.float32(hw)
    per = -(-plan.chunks // fl)
    for i in range(b):
        t = np.zeros((2, c), np.float32)
        for f in range(fl):
            a = np.zeros((2, c), np.float32)
            for k in range(f * per, min((f + 1) * per, plan.chunks)):
                a += part[i, k]
            t += a
        m = t[0] / n
        var = np.maximum(_fma32(-m, m, t[1] / n), np.float32(0))
        r = np.float32(1) / np.sqrt(var + np.float32(eps))
        sc = r * g
        sh = _fma32(-m, sc, be)
        y[i] = _fma32(xf[i], sc, sh)
        mean[i], rstd[i] = m, r
    if relu:
        y = np.maximum(y, np.float32(0))
    return y.reshape(x.shape), mean, rstd


def _reference_fp64(x, g, be, eps, relu):
    x64 = x.astype(np.float64)
    m = x64.mean(axis=(1, 2), keepdims=True)
    var = (x64 ** 2).mean(axis=(1, 2), keepdims=True) - m ** 2
    y = (x64 - m) / np.sqrt(var + eps) * g + be
    return np.maximum(y, 0) if relu else y


# C = 8 and 6 (one and two lane pieces of a 32-byte or 24-byte pixel) and
# 128 (vec: 32 columns, 8 lanes), each cut into 6 chunks of 24 pixels and
# finalized by 4 lanes
@pytest.mark.parametrize("c", [8, 128, 6])
def test_fwd_summation_order_emulated(c):
    x, g, b = _inputs(c)
    plan = fwd_plan(2, 144, c, 4, SMS)._replace(rows=24, chunks=6,
                                                 fin_lanes=4)
    assert plan.vec == (c % 4 == 0)
    y, mean, rstd = _emulate_fwd(x, g, b, 1e-5, True, plan)
    np.testing.assert_allclose(y, _pallas_fwd(c, True), atol=ATOL)
    plain, stats = _instance_norm_fwd(*map(torch.from_numpy, (x, g, b)),
                                      1e-5, True)
    np.testing.assert_allclose(np.stack([mean, rstd]), stats.numpy(),
                               rtol=0, atol=STATS_ATOL)
    exact = _reference_fp64(x, g, b, 1e-5, True)
    err = np.abs(y - exact).max()
    plain_err = np.abs(plain.numpy() - exact).max()
    assert err <= 2 * plain_err, (err, plain_err)
