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
convs on even planes with channel counts that are multiples of 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uig.kernels.conv_pallas import conv3s2_s2d, conv_core as jax_conv_core
from uig_torch.kernels import (conv3s2, conv3s2_act, conv3s2_dgrad,
                               conv3s2_wgrad, conv_core)
from uig_torch.models.layers import PadConv

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2 * 2.0 ** -8)}


def _close(got: torch.Tensor, want, rel: float, what: str) -> None:
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    tol = rel * np.abs(want).max()
    assert err <= tol, f"{what}: max|err| {err:.3g} > {tol:.3g}"


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize("dtype,shape,cout", [
    ("float32", (2, 16, 16, 8), 16), ("bfloat16", (2, 16, 16, 8), 16),
    ("float32", (1, 12, 20, 4), 8)])
def test_conv3s2_matches_jax(dtype, shape, cout):
    jdt, tdt, rel = DTYPES[dtype]
    x, w, b, dy = _arrays(4, shape, (3, 3, shape[3], cout), (cout,),
                          (shape[0], shape[1] // 2, shape[2] // 2, cout))
    w, b = w * 0.1, b * 0.1
    jx, jw, jb, jdy = (jnp.asarray(a, jdt) for a in (x, w, b, dy))
    want, vjp = jax.vjp(conv3s2_s2d, jx, jw, jb)
    wdx, wdw, wdb = vjp(jdy)
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
    want, vjp = jax.vjp(lambda a, b: jax_conv_core(a, b, kh, kh), jx, jw)
    wdx, wdw = vjp(jdy)
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


@pytest.mark.parametrize("bf16", [False, True], ids=["fma", "wgmma"])
@pytest.mark.parametrize("k,cin,cout,pixels", [
    (3, 64, 128, 16 * 128 * 128), (3, 128, 256, 16 * 64 * 64),
    (3, 64, 128, 2 * 128 * 128), (3, 8, 12, 2 * 9 * 15), (3, 4, 4, 4),
    (3, 36, 68, 3 * 17 * 5), (3, 132, 8, 64), (5, 8, 12, 2 * 8 * 10)])
def test_wgrad_chunks_cover_every_pixel_once_in_order(bf16, k, cin, cout,
                                                      pixels):
    """The weight gradient's pixel chunks, as ``_wgrad`` hands them to the
    kernel: chunk z sums [z per, min((z + 1) per, pixels)); together they
    are 0 .. pixels - 1, each once and in order, none empty; on wgmma each
    chunk but the last is whole stages of 64 pixels."""
    from uig_torch.kernels.conv_s2 import _TC_BK, _wgrad_chunks

    chunks, per = _wgrad_chunks(k, cin, cout, pixels, bf16)
    spans = [range(z * per, min((z + 1) * per, pixels))
             for z in range(chunks)]
    assert all(len(s) for s in spans)
    assert [p for s in spans for p in s] == list(range(pixels))
    if bf16:
        assert per % _TC_BK == 0
