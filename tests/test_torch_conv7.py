"""uig_torch.kernels.conv against the JAX 7x7 head conv (``conv7_s2d``, the
Pallas kernel in interpret mode), cin 64 -> 3 at 16^2. The port runs on the
CPU, where the wrapper takes its plain version. fp32; atol 1e-4 as the JAX
package's own conv7_s2d test (49*64-term sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uig.kernels.conv_pallas import conv7_s2d
from uig_torch.kernels import conv7
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
