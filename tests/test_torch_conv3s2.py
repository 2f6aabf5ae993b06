"""uig_torch.kernels.conv_s2 (the 3x3 stride-2 downsample conv and the
generic VALID conv, K4s) against the JAX ``conv3s2_s2d`` and ``conv_core``
(the Pallas kernel in interpret mode), forward and gradients. The port runs
on the CPU, where every wrapper takes its plain version.

Tolerances, each relative to the largest value of the JAX output compared:
  * fp32: 1e-5 (sums over 9 * 16 terms, or over the batch's pixels for the
    weight gradient, taken in another order);
  * bf16: 2 bf16 ulps, 2 * 2^-8. The port sums in fp32 and rounds once;
    JAX's ``conv3s2_s2d`` rounds the conv to bf16 and then adds the bias in
    bf16 (two roundings), and its sums run in another order. The bias
    gradient is the one exception: JAX reduces its bf16 cotangent over the
    pixels in bf16 (a rounding at each partial sum), the port in fp32 with
    one rounding; it is held to the fp32 sum of the bf16 dy within 1 ulp
    (2^-8), and to JAX's within 8 ulps (2^-5).

``PadConv`` routes to ``conv3s2`` exactly the 3x3 stride-2 pad-1 zero-padded
convs on even planes with channel counts that are multiples of 4.

The fp32 CUDA forward, dgrad and wgrad multiply in the three-term TF32
split on the tensor cores; ``test_tf32x3_grads_match_jax`` emulates their
arithmetic in torch (the K stages, each stage's products in the split,
partial sums of the kernels' depth added in fp32, the forward's bias added
after them, the weight gradient's pixel chunks summed in order) and holds
it to JAX's output (the forward's cases, ids ending in ``-fwd``) and VJP
within the fp32 tolerance, on the results ``test_conv3s2_matches_jax``
computes (one cached JAX call a case)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention import _mm3
from uig.kernels.conv_pallas import conv3s2_s2d, conv_core as jax_conv_core
from uig_torch.kernels import (conv3s2, conv3s2_act, conv3s2_dgrad,
                               conv3s2_wgrad, conv_core)
from uig_torch.kernels.conv_s2 import _TF_BK, _wgrad_chunks
from uig_torch.models.layers import PadConv

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2 * 2.0 ** -8)}
# K stages a partial sum in csrc/conv3s2_tf32.cu: 32 channels of one tap
# of C a stage in the forward (UIG_K4S_FWD_DEPTH), 32 channels of F in the
# dgrad (UIG_K4S_DGRAD_DEPTH), 32 pixels in the wgrad (UIG_K4S_WGRAD_DEPTH)
K4S_FWD_DEPTH = 2
K4S_DGRAD_DEPTH = 1
K4S_WGRAD_DEPTH = 2
# JAX's references are compiled whole (op by op, every op compiles) with
# excess precision off, so that XLA on the CPU rounds to bf16 where the
# program says instead of fusing across the roundings, and with XLA's
# backend at optimization level 0 (the same bits, compiled faster)
JAX_OPTIONS = {"xla_allow_excess_precision": False,
               "xla_backend_optimization_level": 0}


def _close(got: torch.Tensor, want, rel: float, what: str) -> None:
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    tol = rel * np.abs(want).max()
    assert err <= tol, f"{what}: max|err| {err:.3g} > {tol:.3g}"


def _compiled(fn, *args):
    """``fn(*args)`` compiled by ``jax.jit`` with ``JAX_OPTIONS``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=JAX_OPTIONS)(
        *args)


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


@functools.lru_cache(maxsize=None)
def _jax_conv3s2(dtype, shape, cout):
    """The inputs of a ``test_conv3s2_matches_jax`` case (numpy, fp32) and
    JAX's output and VJP (dx, dw, db) on them, computed once a case."""
    jdt = DTYPES[dtype][0]
    x, w, b, dy = _arrays(4, shape, (3, 3, shape[3], cout), (cout,),
                          (shape[0], shape[1] // 2, shape[2] // 2, cout))
    w, b = w * 0.1, b * 0.1
    jx, jw, jb, jdy = (jnp.asarray(a, jdt) for a in (x, w, b, dy))

    def run(*a):
        want, vjp = jax.vjp(conv3s2_s2d, *a[:3])
        return (want, *vjp(a[3]))

    return (x, w, b, dy), _compiled(run, jx, jw, jb, jdy)


@pytest.mark.parametrize("dtype,shape,cout", [
    ("float32", (2, 16, 16, 8), 16), ("bfloat16", (2, 16, 16, 8), 16),
    ("float32", (1, 12, 20, 4), 8)])
def test_conv3s2_matches_jax(dtype, shape, cout):
    _, tdt, rel = DTYPES[dtype]
    (x, w, b, dy), (want, wdx, wdw, wdb) = _jax_conv3s2(dtype, shape, cout)
    tx, tw, tb, tdy = (torch.from_numpy(a).to(tdt) for a in (x, w, b, dy))
    got = conv3s2(tx, tw, tb)
    assert got.dtype == tdt
    _close(got, want, rel, "y")
    _close(conv3s2_dgrad(tdy, tw), wdx, rel, "dx")
    _close(conv3s2_wgrad(tx, tdy), wdw, rel, "dw")
    ins = [t.clone().requires_grad_(True) for t in (tx, tw, tb)]
    y = conv3s2_act(*ins)
    _close(y, want, rel, "autograd y")
    gx, gw, gb = torch.autograd.grad(y, ins, tdy)
    _close(gx, wdx, rel, "autograd dx")
    _close(gw, wdw, rel, "autograd dw")
    exact = tdy.to(torch.float64).sum(dim=(0, 1, 2))
    _close(gb, exact, 2.0 ** -8 if dtype == "bfloat16" else rel, "db")
    _close(gb, wdb, 2.0 ** -5 if dtype == "bfloat16" else rel,
           "autograd db against JAX")


def _partials(stages, depth):
    """The sum of ``stages`` (pairs of matrices) as the kernels form it:
    each stage's product in the three-term split, ``depth`` stages a
    partial, the partials added in order in fp32."""
    total = 0.0
    for k, (a, b) in enumerate(stages):
        acc = _mm3(a, b) if k % depth == 0 else acc + _mm3(a, b)
        if k % depth == depth - 1 or k == len(stages) - 1:
            total = total + acc
    return total


def _fwd_tf32x3(x, w, b):
    """conv3s2's y as csrc/conv3s2_tf32.cu forms it: K = the taps (rows,
    then columns) x 32-channel chunks of C; A the zero-padded stride-2
    window at the tap; the bias added to the sum in fp32."""
    nb, h, wd, c = x.shape
    ho, wo = h // 2, wd // 2
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    stages = []
    for di in range(3):
        for dj in range(3):
            a = xp[:, di:di + 2 * ho:2, dj:dj + 2 * wo:2].reshape(-1, c)
            stages += [(a[:, c0:c0 + 32], w[di, dj, c0:c0 + 32])
                       for c0 in range(0, c, 32)]
    return (_partials(stages, K4S_FWD_DEPTH) + b).reshape(nb, ho, wo, -1)


def _dgrad_tf32x3(dy, w):
    """conv3s2's dx as csrc/conv3s2_tf32.cu forms it: by stride-parity class
    (i mod 2, j mod 2) of dx, K = the class's taps (rows, then columns,
    ascending) x 32-channel chunks of F; A the dy pixels at the tap's
    offset, zero outside."""
    nb, ho, wo, f = dy.shape
    c = w.shape[2]
    dyp = torch.nn.functional.pad(dy, (0, 0, 1, 1, 1, 1))
    dx = torch.zeros(nb, 2 * ho, 2 * wo, c)
    for pi in range(2):
        for pj in range(2):
            stages = []
            for di in range(3):
                for dj in range(3):
                    if (pi + 1 - di) % 2 or (pj + 1 - dj) % 2:
                        continue
                    oy, ox = (pi + 1 - di) // 2 + 1, (pj + 1 - dj) // 2 + 1
                    a = dyp[:, oy:oy + ho, ox:ox + wo].reshape(-1, f)
                    stages += [(a[:, o:o + 32], w[di, dj, :, o:o + 32].T)
                               for o in range(0, f, 32)]
            dx[:, pi::2, pj::2] = _partials(stages, K4S_DGRAD_DEPTH).reshape(
                nb, ho, wo, c)
    return dx


def _wgrad_tf32x3(x, dy):
    """conv3s2's dw as csrc/conv3s2_tf32.cu forms it: for each tap, K = the
    batch's pixels in ``_wgrad_chunks``'s ordered chunks of 32-pixel
    stages, each chunk's partial sum, and the chunks added in order (the
    reduce pass)."""
    nb, ho, wo, f = dy.shape
    c = x.shape[3]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    d = dy.reshape(-1, f)
    chunks, per = _wgrad_chunks(3, c, f, d.shape[0], False)
    dw = torch.zeros(3, 3, c, f)
    for di in range(3):
        for dj in range(3):
            a = xp[:, di:di + 2 * ho:2, dj:dj + 2 * wo:2].reshape(-1, c)
            total = 0.0
            for z in range(chunks):
                span = range(z * per, min((z + 1) * per, d.shape[0]), _TF_BK)
                total = total + _partials(
                    [(a[p:p + _TF_BK].T, d[p:p + _TF_BK]) for p in span],
                    K4S_WGRAD_DEPTH)
            dw[di, dj] = total
    return dw


@pytest.mark.parametrize("shape,cout,fwd", [
    pytest.param((2, 16, 16, 8), 16, False, id="shape0-16"),
    pytest.param((1, 12, 20, 4), 8, False, id="shape1-8"),
    pytest.param((2, 16, 16, 8), 16, True, id="shape0-16-fwd"),
    pytest.param((1, 12, 20, 4), 8, True, id="shape1-8-fwd")])
def test_tf32x3_grads_match_jax(shape, cout, fwd):
    (x, w, b, dy), (want, wdx, wdw, _) = _jax_conv3s2("float32", shape,
                                                      cout)
    tx, tw, tb, tdy = map(torch.from_numpy, (x, w, b, dy))
    if fwd:
        _close(_fwd_tf32x3(tx, tw, tb), want, 1e-5, "y")
        return
    _close(_dgrad_tf32x3(tdy, tw), wdx, 1e-5, "dx")
    _close(_wgrad_tf32x3(tx, tdy), wdw, 1e-5, "dw")


@pytest.mark.parametrize("dtype,kh,cin,cout,h", [
    ("float32", 3, 8, 16, 10), ("bfloat16", 3, 8, 16, 10),
    ("float32", 2, 8, 8, 9)])
def test_conv_core_matches_jax(dtype, kh, cin, cout, h):
    jdt, tdt, rel = DTYPES[dtype]
    ho = h - kh + 1
    xp, w, dy = _arrays(1, (2, h, h, cin), (kh * kh * cin, cout),
                        (2, ho, ho, cout))
    w = w * 0.1
    jx, jw, jdy = (jnp.asarray(a, jdt) for a in (xp, w, dy))

    def run(a, b, ct):
        want, vjp = jax.vjp(lambda u, v: jax_conv_core(u, v, kh, kh), a, b)
        return (want, *vjp(ct))

    want, wdx, wdw = _compiled(run, jx, jw, jdy)
    ins = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (xp, w)]
    y = conv_core(*ins, kh, kh)
    _close(y, want, rel, "y")
    gx, gw = torch.autograd.grad(y, ins, torch.from_numpy(dy).to(tdt))
    _close(gx, wdx, rel, "dx")
    _close(gw, wdw, rel, "dw")


def test_checks():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        conv3s2(x, torch.zeros(7, 7, 4, 8))
    with pytest.raises(ValueError, match="even"):
        conv3s2(torch.zeros(1, 9, 8, 4), torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError, match="square"):
        conv_core(x, torch.zeros(24, 8), 3, 2)


@pytest.mark.parametrize("cin,cout,k,stride,pad,mode,h,w,routed", [
    (64, 128, 3, 2, 1, "zeros", 256, 256, True),     # d128
    (128, 256, 3, 2, 1, "zeros", 128, 128, True),    # d256
    (8, 16, 3, 2, 1, "zeros", 12, 20, True),
    (64, 128, 3, 2, 1, "zeros", 255, 256, False),    # odd plane
    (64, 128, 3, 2, 1, "reflect", 256, 256, False),
    (64, 128, 3, 1, 1, "zeros", 256, 256, False),    # stride 1
    (64, 128, 4, 2, 1, "zeros", 256, 256, False),    # the discriminator's
    (3, 64, 3, 2, 1, "zeros", 256, 256, False),      # channels not 4k
    (64, 128, 3, 2, 0, "zeros", 256, 256, False),
])
def test_padconv_routes_exactly_the_downsamples(cin, cout, k, stride, pad,
                                                mode, h, w, routed):
    conv = PadConv(cin, cout, k, stride=stride, pad=pad, pad_mode=mode)
    assert conv.routes_to_conv3s2(h, w) is routed
    assert not conv.routes_to_conv7()


def test_padconv_downsample_runs_conv3s2(monkeypatch):
    """A routed PadConv goes through the K4s autograd function with the
    bias cast to the compute dtype; its map is the zero-padded strided
    conv."""
    import uig_torch.models.layers as layers

    seen = []

    def spy(x, w, bias):
        seen.append((x.dtype, w.dtype, bias.dtype))
        return conv3s2_act(x, w, bias)

    monkeypatch.setattr(layers, "conv3s2_act", spy)
    torch.manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        conv = PadConv(8, 16, 3, stride=2, pad=1, pad_mode="zeros", dtype=dt)
        with torch.no_grad():
            conv.bias.normal_()
        x = torch.randn(2, 12, 12, 8)
        y = conv(x)
        ref = torch.nn.functional.conv2d(
            x.to(dt).float().permute(0, 3, 1, 2),
            conv.kernel.to(dt).float().permute(3, 2, 0, 1),
            conv.bias.to(dt).float(), stride=2, padding=1)
        assert y.dtype == dt and seen[-1] == (dt, dt, dt)
        torch.testing.assert_close(y, ref.permute(0, 2, 3, 1).to(dt),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32x3", "wgmma"])
@pytest.mark.parametrize("k,cin,cout,pixels", [
    (3, 64, 128, 16 * 128 * 128), (3, 128, 256, 16 * 64 * 64),
    (3, 64, 128, 2 * 128 * 128), (3, 8, 12, 2 * 9 * 15), (3, 4, 4, 4),
    (3, 36, 68, 3 * 17 * 5), (3, 132, 8, 64), (5, 8, 12, 2 * 8 * 10)])
def test_wgrad_chunks_cover_every_pixel_once_in_order(bf16, k, cin, cout,
                                                      pixels):
    """The weight gradient's pixel chunks, as ``_wgrad`` hands them to the
    kernel: chunk z sums [z per, min((z + 1) per, pixels)); together they
    are 0 .. pixels - 1, each once and in order, none empty; each chunk
    but the last is whole stages: 64 pixels on wgmma (bf16), 32 on tf32x3
    (fp32)."""
    from uig_torch.kernels.conv_s2 import _TC_BK

    chunks, per = _wgrad_chunks(k, cin, cout, pixels, bf16)
    spans = [range(z * per, min((z + 1) * per, pixels))
             for z in range(chunks)]
    assert all(len(s) for s in spans)
    assert [p for s in spans for p in s] == list(range(pixels))
    assert per % (_TC_BK if bf16 else _TF_BK) == 0
