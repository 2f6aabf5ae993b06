"""The port's whole ResNet generator against the JAX one: base 64, one
residual block, 16^2, the same flax parameters. JAX runs once with its
Pallas kernels (conv_impl="pallas" routes the 64 -> 3 head to conv7_s2d,
convin_pallas=True the trunk to conv3_in_act; both in interpret mode) and
once with the XLA default. The port runs on the CPU (plain versions).
fp32 at "highest" precision; atol 5e-5 as the JAX package's own
conv_impl parity test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from uig.models import ResNetGenerator as JaxGenerator
from uig_torch.convert import generator_state_from_flax
from uig_torch.models import ResNetGenerator

ATOL = 5e-5
# XLA's backend at optimization level 0: the same results, compiled in
# about a third of the time (the Pallas kernels run in interpret mode)
JAX_OPTIONS = {"xla_backend_optimization_level": 0}


def _compiled(fn, *args):
    """``fn(*args)`` under one ``jax.jit``, compiled with ``JAX_OPTIONS``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=JAX_OPTIONS)(
        *args)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    # flax's parameter shapes from jax.eval_shape (a trace, no compile);
    # values as the generator's initializers draw them (kernels
    # normal(0.02), unit scales, zero biases), drawn with numpy
    shapes = jax.eval_shape(JaxGenerator(n_res_blocks=1).init,
                            jax.random.PRNGKey(0), jnp.asarray(x))
    flat = {k: (0.02 * rng.standard_normal(v.shape) if k.endswith("kernel")
                else np.full(v.shape, 1.0 * k.endswith("scale"))
                ).astype(np.float32)
            for k, v in sorted(traverse_util.flatten_dict(
                shapes, sep="/").items())}
    # move IN scale/bias and conv biases off their init values
    for k in flat:
        if k.endswith(("/bias", "/scale")):
            flat[k] = flat[k] + 0.1 * rng.standard_normal(flat[k].shape).astype(
                np.float32)
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    port = ResNetGenerator(n_res_blocks=1)
    port.load_state_dict(generator_state_from_flax(flat, port), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    return x, params, got


@pytest.mark.parametrize("jax_kernels", [True, False])
def test_generator_matches_jax(setup, jax_kernels):
    x, params, got = setup
    kw = dict(conv_impl="pallas", convin_pallas=True) if jax_kernels else {}
    gen = JaxGenerator(n_res_blocks=1, **kw)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(_compiled(gen.apply, params, jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 16, 16, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("upsample", ["conv_transpose", "resize_conv"])
def test_antialias_generator_matches_jax(upsample):
    """resample="antialias" (the official CUT generator's BlurPool and
    BlurUpsample; ``upsample`` is then ignored, as in JAX): base 8, one
    residual block, flax's parameter shapes from ``jax.eval_shape`` with
    values drawn by numpy."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    kw = dict(base_features=8, n_res_blocks=1, resample="antialias",
              upsample=upsample)
    jg = JaxGenerator(**kw)
    shapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0), jnp.asarray(x))
    flat = {k: (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
                if k.endswith("kernel") else
                1.0 * k.endswith("scale") + 0.1 * rng.standard_normal(v.shape)
                ).astype(np.float32)
            for k, v in sorted(traverse_util.flatten_dict(
                shapes, sep="/").items())}
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    port = ResNetGenerator(**kw)
    assert port.num_layers == jg.num_layers == 3 + 8 + 1 + 8 + 2
    port.load_state_dict(generator_state_from_flax(flat, port), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jg.apply)(params, jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)
