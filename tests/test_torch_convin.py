"""uig_torch.kernels.convin against the JAX fused conv3+IN (the Pallas
kernel in interpret mode). The port runs on the CPU, where the wrapper takes
its plain version. fp32; atol 1e-5 covers sums over 9*16 terms and 64 pixels
taken in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uig.kernels.convin_pallas import conv3_in_act as jax_conv3_in_act
from uig_torch.kernels import conv3_in_act

ATOL = 1e-5


def _inputs(seed=0, shape=(2, 8, 8, 16)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    g = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    be = (rng.standard_normal(c) * 0.2).astype(np.float32)
    return x, w, b, g, be


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3_in_act_matches_jax(pad_mode, relu):
    arrs = _inputs()
    got = conv3_in_act(*map(torch.from_numpy, arrs), relu=relu,
                       pad_mode=pad_mode).numpy()
    ref = np.asarray(jax_conv3_in_act(*map(jnp.asarray, arrs), relu=relu,
                                      pad_mode=pad_mode))
    assert got.shape == ref.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_bad_pad_mode_and_shapes_raise():
    x, w, b, g, be = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="pad_mode"):
        conv3_in_act(x, w, b, g, be, relu=True, pad_mode="circular")
    with pytest.raises(ValueError, match="bad shapes"):
        conv3_in_act(x, w[:, :, :8], b, g, be, relu=True)
