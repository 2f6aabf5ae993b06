"""uig_torch.kernels.augment ``augment_batch`` (the plain version of the
augment kernel, which the wrapper runs for CPU tensors) against the JAX
``augment_batch_pallas`` (interpret mode on the CPU) and ``augment_batch``,
with the JAX functions' own draws injected. Both compute x * (2/255) - 1 in
fp32 from the same pixels: bit-equal to ``augment_batch``, and within 1 ulp
(2.4e-7) of the Pallas kernel, whose XLA lowering may contract the scale
into an FMA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uig.kernels.augment import augment_batch as jax_augment_batch
from uig.kernels.augment_pallas import augment_batch_pallas
from uig_torch.kernels import augment_batch, draw_augment


def _jax_draws(key, b, h, w, crop):
    """The offsets and flips both JAX functions derive from ``key``."""
    k_off, k_flip = jax.random.split(key)
    oy = jax.random.randint(k_off, (b,), 0, h - crop + 1)
    ox = jax.random.randint(jax.random.fold_in(k_off, 1), (b,), 0,
                            w - crop + 1)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    return tuple(torch.from_numpy(np.array(v)) for v in (oy, ox, flip))


@pytest.mark.parametrize("shape,crop,seed", [((2, 36, 36, 3), 32, 0),
                                             ((3, 20, 27, 3), 16, 1),
                                             ((4, 9, 9, 1), 8, 2)])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_matches_jax(shape, crop, seed, impl):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    fn = augment_batch_pallas if impl == "pallas" else jax_augment_batch
    want = np.asarray(fn(jnp.asarray(x), key, crop))
    oy, ox, flip = _jax_draws(key, shape[0], shape[1], shape[2], crop)
    got = augment_batch(torch.from_numpy(x), oy, ox, flip, crop).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if impl == "xla":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def test_flip_mirrors_columns():
    x = torch.arange(2 * 4 * 5 * 3, dtype=torch.uint8).reshape(2, 4, 5, 3)
    zero = torch.zeros(2, dtype=torch.long)
    plain = augment_batch(x, zero, zero, torch.tensor([False, False]), 4)
    flipped = augment_batch(x, zero, zero, torch.tensor([True, False]), 4)
    torch.testing.assert_close(flipped[0], plain[0].flip(1), rtol=0, atol=0)
    torch.testing.assert_close(flipped[1], plain[1], rtol=0, atol=0)


def test_draws_cover_the_ranges_and_repeat():
    def draw(seed):
        return draw_augment(torch.Generator().manual_seed(seed), 4000, 286,
                            290, 256)

    oy, ox, flip = draw(0)
    assert int(oy.min()) == 0 and int(oy.max()) == 30
    assert int(ox.min()) == 0 and int(ox.max()) == 34
    assert 0.45 < flip.float().mean().item() < 0.55
    for u, v in zip(draw(0), draw(0)):
        assert torch.equal(u, v)


def test_checks():
    x = torch.zeros(2, 10, 10, 3, dtype=torch.uint8)
    z = torch.zeros(2, dtype=torch.long)
    f = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="uint8"):
        augment_batch(x.float(), z, z, f, 8)
    with pytest.raises(ValueError, match="exceeds"):
        augment_batch(x, z, z, f, 12)
    with pytest.raises(ValueError, match="out of range"):
        augment_batch(x, z + 3, z, f, 8)
    with pytest.raises(ValueError, match="shape"):
        augment_batch(x, z[:1], z, f, 8)
