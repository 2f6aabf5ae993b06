"""The modules of CUT, FastCUT and DCLGAN in the port against the JAX
package's: ``patch_nce_loss``; the ResNet generator's feature taps
(``with_features``, ``encode_features``) in both resample modes, values and
the gradients of every tap and the output; ``BlurPool`` and
``BlurUpsample``; the projection head and the patch gather; the patch-id
draw. The port runs on the CPU (plain versions of every kernel). Each JAX
reference is one jitted program, compiled with XLA's backend optimization
off (the same bits, less compile time), except the antialias generator's
taps: at level 0 XLA got its input gradient wrong, by 0.40 at a largest
value of 32 (the default level, and ``jax.grad`` op by op, agree with each
other and with the port within 7e-5), so that program keeps XLA's
defaults.

Tolerances, fp32 on both sides (sums in another order): values and input
gradients within 1e-5 of their largest magnitude (the taps, 1e-5 absolute
for O(1) activations); parameter gradients within 1e-5 of the network's
largest gradient (a conv bias that feeds an instance norm has a true
gradient of 0 and its computed values are rounding noise at that scale);
the blur filters within 1e-6 (a few exact products and one sum). In bf16,
the blur filters and the head within one bf16 ulp of the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from uig.models import ResNetGenerator as JaxGenerator
from uig.models.layers import BlurPool as JaxBlurPool
from uig.models.layers import BlurUpsample as JaxBlurUpsample
from uig.train.cut import ProjectionHead as JaxHead
from uig.train.cut import _sample_patches
from uig.train.losses import patch_nce_loss as jax_patch_nce_loss
from uig_torch.models import ResNetGenerator
from uig_torch.models.layers import BlurPool, BlurUpsample
from uig_torch.train.cut import (ProjectionHead, _method_call, _Method,
                                 draw_patch_ids, lecun_normal_init,
                                 sample_patches)
from uig_torch.train.losses import patch_nce_loss

JAX_OPTIONS = {"xla_backend_optimization_level": 0}
REL = 1e-5


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=JAX_OPTIONS)(
        *args)


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: max|err| {err:.3g} > {atol:.3g}"


def _bf16_ulp_close(got: torch.Tensor, want, what=""):
    """Within one bf16 ulp of the largest magnitude of ``want``."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    m = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(m)) - 7)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= ulp, f"{what}: max|err| {err:.3g} > 1 bf16 ulp {ulp:.3g}"


# --------------------------------------------------------------- PatchNCE
def test_patch_nce_loss_matches_jax():
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((2, 24, 16)).astype(np.float32)
            for _ in range(2))
    v, (gq, gk) = _compiled(jax.value_and_grad(
        lambda a, b: jax_patch_nce_loss(a, b, 0.07), argnums=(0, 1)),
        jnp.asarray(q), jnp.asarray(k))
    tq, tk = (torch.from_numpy(a).requires_grad_(True) for a in (q, k))
    loss = patch_nce_loss(tq, tk, 0.07)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(v), rtol=1e-6)
    _close(tq.grad, gq, what="dq")
    _close(tk.grad, gk, what="dk")
    # bf16 features: the loss casts to fp32 first
    lb = patch_nce_loss(tq.detach().bfloat16(), tk.detach().bfloat16(), 0.07)
    vb = jax_patch_nce_loss(jnp.asarray(q, jnp.bfloat16),
                            jnp.asarray(k, jnp.bfloat16), 0.07)
    assert lb.dtype == torch.float32
    np.testing.assert_allclose(float(lb), float(vb), rtol=1e-6)


# ------------------------------------------------------ generator feature taps
# taps over every kind of layer: the stem conv before its norm, a norm
# before its ReLU (the port runs that pair unfused), a fused norm+ReLU's
# output, a BlurPool's output and a residual block's output
TAPS = {"strided": (0, 1, 4, 8, 9), "antialias": (0, 4, 6, 8, 11)}
SIZE = 16


def _gen_pair(resample: str, seed: int = 0):
    """JAX's and the port's generator (base 8, one residual block) with the
    same parameters, drawn with numpy in ``jax.eval_shape``'s shapes and
    moved off their initial values."""
    jg = JaxGenerator(base_features=8, n_res_blocks=1, resample=resample)
    x = np.random.default_rng(seed).uniform(
        -1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed + 1)
    flat = {}
    for k, v in sorted(traverse_util.flatten_dict(shapes["params"],
                                                  sep=".").items()):
        if k.endswith("kernel"):
            a = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        else:
            a = (np.ones if k.endswith("scale") else np.zeros)(v.shape)
            a = a + 0.1 * rng.standard_normal(v.shape)
        flat[k] = a.astype(np.float32)
    pg = ResNetGenerator(base_features=8, n_res_blocks=1, resample=resample)
    pg.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()},
                       strict=True)
    jparams = {"params": traverse_util.unflatten_dict(
        {tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()})}
    return jg, jparams, pg, x, flat


@pytest.fixture(scope="module", params=["strided", "antialias"])
def taps_case(request):
    resample = request.param
    taps = TAPS[resample]
    jg, jparams, pg, x, flat = _gen_pair(resample)
    assert pg.num_layers == jg.num_layers
    y_shape, f_shapes = jax.eval_shape(
        lambda p, v: jg.apply(p, v, taps, method=JaxGenerator.with_features),
        jparams, jnp.asarray(x))
    rng = np.random.default_rng(7)
    cts = [rng.standard_normal(s.shape).astype(np.float32)
           for s in [y_shape, *f_shapes]]

    def fwd_bwd(p, v, cts):
        def f(p, v):
            return jg.apply(p, v, taps, method=JaxGenerator.with_features)
        (y, feats), vjp = jax.vjp(f, p, v)
        gp, gx = vjp((cts[0], list(cts[1:])))
        enc = jg.apply(p, v, taps, method=JaxGenerator.encode_features)
        return y, feats, gp, gx, enc

    args = (jparams, jnp.asarray(x), [jnp.asarray(c) for c in cts])
    with jax.default_matmul_precision("highest"):
        # XLA's defaults for the antialias program (module docstring)
        ref = (jax.jit(fwd_bwd)(*args) if resample == "antialias"
               else _compiled(fwd_bwd, *args))

    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in flat.items()}
    pg.requires_grad_(False)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, feats = _method_call(_Method(pg, "with_features"), params, tx, taps)
    total = sum((o * torch.from_numpy(c)).sum()
                for o, c in zip([y, *feats], cts))
    total.backward()
    with torch.no_grad():
        enc = pg.encode_features(tx.detach(), taps)
    got = {"y": y.detach(), "feats": [f.detach() for f in feats],
           "gx": tx.grad, "gp": {k: p.grad for k, p in params.items()},
           "enc": enc,
           "shapes": pg.feature_shapes(taps, SIZE, SIZE)}
    return resample, taps, ref, got


def test_taps_values_match_jax(taps_case):
    resample, taps, (y, feats, _, _, enc), got = taps_case
    _close(got["y"], y, what=f"{resample} output")
    assert len(got["feats"]) == len(feats) == len(taps)
    for t, a, b in zip(taps, got["feats"], feats):
        _close(a, b, what=f"{resample} tap {t}")
    # encode_features stops at the last tap with the same features
    assert len(got["enc"]) == len(enc)
    for t, a, b in zip(taps, got["enc"], enc):
        _close(a, b, what=f"{resample} encoder tap {t}")
    assert [tuple(f.shape[1:]) for f in got["feats"]] == got["shapes"]


def test_taps_gradients_match_jax(taps_case):
    resample, taps, (_, _, gp, gx, _), got = taps_case
    _close(got["gx"], gx, what=f"{resample} input gradient")
    want = {".".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(gp["params"]).items()}
    assert set(want) == set(got["gp"])
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        err = float(np.abs(got["gp"][k].numpy() - v).max())
        assert err <= REL * scale, f"{resample} grad {k}: {err:.3g}"


def test_encoder_stops_at_the_last_tap():
    """The NCE passes never run the decoder: encode_features calls no
    layer after the last tap."""
    pg = ResNetGenerator(base_features=8, n_res_blocks=2)
    called = []
    for i, kind in enumerate(pg.kinds):
        if kind == "module":
            getattr(pg, f"layers_{i}").register_forward_hook(
                lambda m, a, o, i=i: called.append(i))
    with torch.no_grad():
        pg.encode_features(torch.zeros(1, SIZE, SIZE, 3), (0, 4, 8))
    assert max(called) == 7 and pg.num_layers == JaxGenerator(
        base_features=8, n_res_blocks=2).num_layers


# --------------------------------------------------------------- blur filters
BLURS = [("pool", 3, "reflect"), ("pool", 3, "repl"), ("pool", 4, "zeros"),
         ("up", 4, "repl"), ("up", 4, "reflect"), ("up", 3, "repl")]


def _blur_case(kind, filt, mode):
    rng = np.random.default_rng(filt)
    x = rng.standard_normal((2, 9, 10, 5)).astype(np.float32)
    ct = rng.standard_normal((2, 5, 5, 5) if kind == "pool"
                             else (2, 18, 20, 5)).astype(np.float32)
    return x, ct


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def blur_refs(request):
    """JAX's output and input gradient of every case of BLURS in one
    program a dtype."""
    jdt = jnp.dtype(request.param)
    mods = [JaxBlurPool(filt_size=f, pad_mode=m, dtype=jdt) if k == "pool"
            else JaxBlurUpsample(filt_size=f, pad_mode=m, dtype=jdt)
            for k, f, m in BLURS]
    cases = [_blur_case(*b) for b in BLURS]

    def fwd_bwd(xs, cts):
        out = []
        for jm, v, c in zip(mods, xs, cts):
            y, vjp = jax.vjp(lambda u, jm=jm: jm.apply({}, u), v)
            out.append((y, vjp(c.astype(y.dtype))[0]))
        return out

    refs = _compiled(fwd_bwd, [jnp.asarray(x, jdt) for x, _ in cases],
                     [jnp.asarray(c) for _, c in cases])
    return request.param, dict(zip(BLURS, refs))


@pytest.mark.parametrize("kind,filt,mode", BLURS)
def test_blur_matches_jax(blur_refs, kind, filt, mode):
    dtype, refs = blur_refs
    y, gx = refs[(kind, filt, mode)]
    x, ct = _blur_case(kind, filt, mode)
    tdt = getattr(torch, dtype)
    pm = (BlurPool(filt, pad_mode=mode, dtype=tdt) if kind == "pool"
          else BlurUpsample(filt, pad_mode=mode, dtype=tdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out = pm(tx)
    out.backward(torch.from_numpy(ct).to(out.dtype))
    assert out.shape == y.shape and out.dtype == tdt
    if dtype == "float32":
        _close(out.detach(), y, 1e-6, "output")
        _close(tx.grad, gx, 1e-6, "input gradient")
    else:
        _bf16_ulp_close(out.detach(), y, "output")
        _bf16_ulp_close(tx.grad, gx, "input gradient")


# -------------------------------------------------------- heads and patches
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_and_patch_gather_match_jax(dtype):
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((2, 6, 5, 12)).astype(np.float32)
    idx = np.stack([rng.permutation(30)[:16] for _ in range(2)]).astype(
        np.int32)
    head = ProjectionHead(12, 32, getattr(torch, dtype))
    params = lecun_normal_init(head, torch.Generator().manual_seed(0))
    params = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator(
        ).manual_seed(1)) for k, v in params.items()}
    jparams = {"params": traverse_util.unflatten_dict(
        {tuple(k.split(".")): jnp.asarray(v.numpy())
         for k, v in params.items()})}
    jh = JaxHead(32, dtype=jnp.dtype(dtype))
    tfeat = torch.from_numpy(feat).to(getattr(torch, dtype))
    patches = sample_patches(tfeat, torch.from_numpy(idx).long())
    want_p = _sample_patches(jnp.asarray(feat, jnp.dtype(dtype)),
                             jnp.asarray(idx))
    np.testing.assert_array_equal(patches.float().numpy(),
                                  np.asarray(want_p, np.float32))
    want = _compiled(jh.apply, jparams, want_p)
    got = torch.func.functional_call(head, params, (patches,))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 16, 32)
    if dtype == "float32":
        _close(got, want, what="head")
    else:
        _bf16_ulp_close(got, want, "head")


def test_lecun_init_and_patch_ids():
    """flax's Dense kernel init (truncated at 2 sigma, variance 1/fan_in)
    and patch ids that are distinct within each image."""
    head = ProjectionHead(256, 256)
    p = lecun_normal_init(head, torch.Generator().manual_seed(0))
    k = p["Dense_0.kernel"]
    std = 1.0 / np.sqrt(256)
    assert float(k.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-7
    assert abs(float(k.std()) / std - 1.0) < 0.02
    assert not p["Dense_0.bias"].any()
    ids = draw_patch_ids(5, [(8, 8, 4), (4, 2, 4)], 3, 16, "cpu")
    assert [tuple(i.shape) for i in ids] == [(3, 16), (3, 8)]
    for i, hw in zip(ids, (64, 8)):
        for row in i:
            assert len(set(row.tolist())) == row.numel()
            assert 0 <= int(row.min()) and int(row.max()) < hw
    again = draw_patch_ids(5, [(8, 8, 4), (4, 2, 4)], 3, 16, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(ids, again))
