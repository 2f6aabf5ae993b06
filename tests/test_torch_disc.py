"""uig_torch.models.PatchDiscriminator against the JAX PatchDiscriminator:
the same flax parameters (converted by a rename), the same NHWC input, fp32.
The logit map within 1e-5; the input gradient and the parameter gradients
of a fixed cotangent within 1e-5 of their largest value (4x4 convs over up
to 16 * 32 channels and sums over the batch, in another order). A 3-layer
D needs 32^2 for a non-empty (2, 2) map; 16^2 runs with 2 layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from uig.models import PatchDiscriminator as JaxDisc
from uig_torch.models import PatchDiscriminator

ATOL = 1e-5


def _init(shape, key: str, rng) -> np.ndarray:
    """flax's default initial value of a parameter, drawn with numpy:
    lecun-normal kernels, unit scales, zero biases."""
    if key.endswith("kernel"):
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    return np.ones(shape) if key.endswith("scale") else np.zeros(shape)


def _pair(size, layers, norm, seed=0):
    """JAX's and the port's D with the same parameters: the shapes from
    ``jax.eval_shape`` of flax's init (an eager init compiles every random
    op), the values drawn with numpy, then moved off their initial values
    by 0.1 N."""
    jd = JaxDisc(base_features=8, n_layers=layers, norm=norm)
    x = np.random.default_rng(seed).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed + 1)
    flat = {k: (_init(v.shape, k, rng) + 0.1 * rng.standard_normal(v.shape)
                ).astype(np.float32) for k, v in sorted(
            traverse_util.flatten_dict(shapes["params"], sep=".").items())}
    pd = PatchDiscriminator(base_features=8, n_layers=layers, norm=norm)
    pd.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()},
                       strict=True)
    jparams = {"params": traverse_util.unflatten_dict(
        {tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()})}
    return jd, jparams, pd, x


@pytest.mark.parametrize("size,layers,norm", [(32, 3, "instance"),
                                              (16, 2, "instance"),
                                              (32, 3, "none")])
def test_forward_and_gradients_match_jax(size, layers, norm):
    jd, jparams, pd, x = _pair(size, layers, norm)
    shape = jax.eval_shape(jd.apply, jparams, jnp.asarray(x)).shape
    ct = np.random.default_rng(9).standard_normal(shape).astype(np.float32)

    # one compile of the forward and its vjp (op by op, it compiles every op)
    @jax.jit
    def fwd_bwd(p, t, ct):
        y, vjp = jax.vjp(jd.apply, p, t)
        return y, vjp(ct)

    args = (jparams, jnp.asarray(x), jnp.asarray(ct))
    # XLA's backend at optimization level 0: the same results, compiled faster
    want, (wp, wx) = fwd_bwd.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    xt = torch.from_numpy(x).requires_grad_(True)
    params = dict(pd.named_parameters())
    got = pd(xt)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    grads = torch.autograd.grad(got, [xt] + list(params.values()),
                                torch.from_numpy(ct))
    wx = np.asarray(wx)
    np.testing.assert_allclose(grads[0].numpy(), wx, rtol=0,
                               atol=ATOL * np.abs(wx).max())
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        wp["params"], sep=".").items()}
    assert set(flat) == set(params)
    for name, g in zip(params, grads[1:]):
        np.testing.assert_allclose(g.numpy(), flat[name], rtol=0,
                                   atol=ATOL * np.abs(flat[name]).max(),
                                   err_msg=name)


def test_parameter_names_follow_flax():
    names = set(dict(PatchDiscriminator(8, 3).named_parameters()))
    assert names == {"PadConv_0.kernel", "PadConv_0.bias", "PadConv_1.kernel",
                     "PadConv_2.kernel", "PadConv_3.kernel", "PadConv_4.kernel",
                     "PadConv_4.bias", "InstanceNorm_0.scale",
                     "InstanceNorm_0.bias", "InstanceNorm_1.scale",
                     "InstanceNorm_1.bias", "InstanceNorm_2.scale",
                     "InstanceNorm_2.bias"}
    none = dict(PatchDiscriminator(8, 3, norm="none").named_parameters())
    assert "PadConv_1.bias" in none and not any("Instance" in k for k in none)


@pytest.mark.parametrize("size,layers", [(16, 3), (8, 2)])
def test_empty_logit_map_raises(size, layers):
    pd = PatchDiscriminator(8, layers)
    with pytest.raises(ValueError, match="EMPTY logit map"):
        pd(torch.zeros(1, size, size, 3))
    assert pd.map_size(size, size) == (0, 0)
    assert PatchDiscriminator(8, 3).map_size(256, 256) == (30, 30)
