"""Each kernel module's plain version in bf16 (the port on the CPU, where
every wrapper takes it) against its JAX counterpart in bf16, the Pallas
kernel in interpret mode, at tiny shapes: K1 ``augment_batch_pallas``, K2f/
K2b ``instance_norm_pallas`` and its vjp, K3 ``conv3_in_act`` and its vjp,
K4f/K4d/K4w ``conv7_s2d`` at cin 32 and its vjp. Inputs are made with numpy
from a seed and rounded to bf16 the same way on both sides.

The unit is one bf16 ulp of the largest magnitude of the JAX output
compared, ulp(M) = 2^(floor(log2 M) - 7). Both sides sum in fp32 from the
bf16 values and round each output; what differs, and the tolerance that
absorbs it:
  * K1, K2f, K4f forward: the order of fp32 operations before the one
    rounding, so an output at a rounding boundary may land one ulp apart:
    1 ulp;
  * K3 forward: the conv output is rounded to bf16 before the norm in both,
    and one ulp of it there moves the normalized output by up to an ulp:
    2 ulps;
  * K2b dx, K4d, K4w: JAX rounds more often. Its head dgrad adds the reflect
    ring in bf16 after the conv's rounding (``_fold_block``), its head wgrad
    rounds each coarse weight slot to bf16 before the 7x7 transpose sums 16
    of them; the port folds and sums in fp32 and rounds once: 2 ulps, and
    4 for dw (16 rounded slots);
  * K3 backward: the norm backward's output is rounded to bf16 in both, and
    its dx and dw are bf16 library convs whose reflect adjoint adds in bf16,
    in another order in each package: 4 ulps;
  * dgamma, dbeta (fp32 in both, sums over the batch): 1e-5 of the largest,
    as in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uig.kernels.augment_pallas import augment_batch_pallas
from uig.kernels.conv_pallas import conv7_s2d
from uig.kernels.convin_pallas import conv3_in_act as jax_conv3_in_act
from uig.kernels.norm_pallas import instance_norm_pallas
from uig_torch.kernels import (augment_batch, conv3_in_act, conv7_act,
                               instance_norm_act)

BF = torch.bfloat16


def _ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _close(got: torch.Tensor, want, ulps: float, what: str) -> None:
    assert got.dtype == BF, (what, got.dtype)
    got = got.detach().to(torch.float32).numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, tol = np.abs(got - want).max(), ulps * _ulp(np.abs(want).max())
    assert err <= tol, f"{what}: max|err| {err:.4g} > {ulps} ulps = {tol:.4g}"


def _close32(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


def _vjp(fn, dy, *args):
    """(fn(*args), the VJP of ``dy``) under one ``jax.jit``, compiled with
    excess precision off (XLA rounds to bf16 where the program says, as
    when its ops run one by one) and XLA's backend at optimization level 0
    (a fraction of the compile time)."""
    def both(dy, *a):
        y, vjp = jax.vjp(fn, *a)
        return y, vjp(dy)

    return jax.jit(both).lower(dy, *args).compile(compiler_options={
        "xla_allow_excess_precision": False,
        "xla_backend_optimization_level": 0})(dy, *args)


def _arrays(seed, *specs):
    """fp32 numpy arrays, each ``(shape, scale, shift)``."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * sc + sh).astype(np.float32)
            for s, sc, sh in specs]


def _pair(a: np.ndarray, bf16: bool = True):
    """The same values for JAX and for the port (rounded to bf16 alike)."""
    if not bf16:
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(BF)


@pytest.mark.parametrize("shape,crop", [((3, 20, 27, 3), 16)])
def test_augment(shape, crop):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(1)
    want = augment_batch_pallas(jnp.asarray(x), key, crop,
                                out_dtype=jnp.bfloat16)
    k_off, k_flip = jax.random.split(key)
    b, h, w, _ = shape
    oy = jax.random.randint(k_off, (b,), 0, h - crop + 1)
    ox = jax.random.randint(jax.random.fold_in(k_off, 1), (b,), 0,
                            w - crop + 1)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    got = augment_batch(torch.from_numpy(x),
                        *(torch.from_numpy(np.array(v)) for v in (oy, ox, flip)),
                        crop, out_dtype=BF)
    _close(got, want, 1, "augment")


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm(relu):
    x, g, b, dy = _arrays(2, ((2, 8, 8, 16), 2.0, 0.5), ((16,), 0.2, 1.0),
                          ((16,), 0.2, 0.0), ((2, 8, 8, 16), 1.0, 0.0))
    (jx, tx), (jdy, tdy) = _pair(x), _pair(dy)
    (jg, tg), (jb, tb) = _pair(g, False), _pair(b, False)
    want, (wdx, wdg, wdb) = _vjp(
        lambda *a: instance_norm_pallas(*a, relu=relu), jdy, jx, jg, jb)
    ins = [t.clone().requires_grad_(True) for t in (tx, tg, tb)]
    y = instance_norm_act(*ins, relu=relu)
    _close(y, want, 1, "y")
    dx, dg, db = torch.autograd.grad(y, ins, tdy)
    _close(dx, wdx, 2, "dx")
    _close32(dg, wdg, "dgamma")
    _close32(db, wdb, "dbeta")


@pytest.mark.parametrize("pad_mode,relu", [("reflect", True),
                                           ("zeros", False)])
def test_conv3_in(pad_mode, relu):
    x, w, b, g, be, dy = _arrays(
        3, ((2, 8, 8, 16), 1.0, 0.0), ((3, 3, 16, 16), 0.1, 0.0),
        ((16,), 0.1, 0.0), ((16,), 0.2, 1.0), ((16,), 0.2, 0.0),
        ((2, 8, 8, 16), 1.0, 0.0))
    (jx, tx), (jdy, tdy) = _pair(x), _pair(dy)
    jw, tw = _pair(w, False)
    params = [_pair(a, False) for a in (b, g, be)]
    want, (wdx, wdw, wdb, wdg, wdbe) = _vjp(
        lambda *a: jax_conv3_in_act(*a, relu=relu, pad_mode=pad_mode),
        jdy, jx, jw, *(p[0] for p in params))
    # the port's layer casts the fp32 kernel to bf16, as JAX's kernel call
    ins = [t.clone().requires_grad_(True) for t in (tx, tw)]
    ins += [p[1].clone().requires_grad_(True) for p in params]
    y = conv3_in_act(ins[0], ins[1].to(BF), *ins[2:], relu=relu,
                     pad_mode=pad_mode)
    _close(y, want, 2, "y")
    dx, dw, db, dg, dbe = torch.autograd.grad(y, ins, tdy)
    _close(dx, wdx, 4, "dx")
    _close(dw.to(BF), wdw, 4, "dw")
    # the conv bias feeds the norm: its true gradient is 0, both sides give
    # rounding noise, held at the scale of dgamma
    np.testing.assert_allclose(db.numpy(), np.asarray(wdb), rtol=0,
                               atol=2.0 ** -8 * np.abs(np.asarray(wdg)).max())
    _close32(dg, wdg, "dgamma")
    _close32(dbe, wdbe, "dbeta")


@pytest.mark.parametrize("pad_mode", ["reflect"])
def test_conv7(pad_mode):
    x, w, b, dy = _arrays(7, ((2, 16, 16, 32), 1.0, 0.0),
                          ((7, 7, 32, 3), 0.05, 0.0), ((3,), 0.1, 0.0),
                          ((2, 16, 16, 3), 1.0, 0.0))
    (jx, tx), (jw, tw), (jb, tb), (jdy, tdy) = map(_pair, (x, w, b, dy))
    want, (wdx, wdw, wdb) = _vjp(
        lambda *a: conv7_s2d(*a, pad_mode=pad_mode), jdy, jx, jw, jb)
    ins = [t.clone().requires_grad_(True) for t in (tx, tw, tb)]
    y = conv7_act(*ins, pad_mode)
    _close(y, want, 1, "y")
    dx, dw, db = torch.autograd.grad(y, ins, tdy)
    _close(dx, wdx, 2, "dx")
    _close(dw, wdw, 4, "dw")
    _close(db, wdb, 1, "db")


def test_bf16_refusals_point_to_the_roadmap():
    """bf16 training and bf16 serving of CycleGAN and VQGAN are ported
    (``model.eval_dtype=bfloat16`` builds the generator in bf16); bf16 for
    a kind that runs in float32 only raises with its ROADMAP item."""
    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.models import generator_from_config, model_dtype

    cyc = get_preset("cyclegan256_dp").model
    assert cyc.compute_dtype == "bfloat16"
    assert model_dtype(cyc, "compute_dtype") == BF
    assert generator_from_config(cyc, "compute_dtype").dtype == BF
    served = apply_overrides(get_preset("cyclegan256_dp"),
                             ["model.eval_dtype=bfloat16"]).model
    assert generator_from_config(served).dtype == BF
    other = apply_overrides(get_preset("cyclegan256_dp"),
                            ["model.eval_dtype=bfloat16",
                             "model.kind=unit"]).model
    with pytest.raises(NotImplementedError, match="ROADMAP: unit in bf16"):
        model_dtype(other, "eval_dtype")
    vq = get_preset("vqgan512").model
    assert vq.compute_dtype == "bfloat16"
    assert generator_from_config(vq, "compute_dtype").encoder.dtype == BF
    served = apply_overrides(get_preset("vqgan512"),
                             ["model.eval_dtype=bfloat16"]).model
    assert generator_from_config(served).encoder.dtype == BF
