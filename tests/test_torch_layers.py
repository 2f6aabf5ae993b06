"""uig_torch.models.layers against the flax layers of the JAX package, with
the same parameters (converted by rename) and the same numpy inputs. The
port runs on the CPU. fp32; atol 1e-5 covers conv sums of at most 9*16
terms taken in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from uig.models import layers as jl
from uig_torch.models import layers as tl

ATOL = 1e-5


def _port(module, flax_vars, perturb_seed=0):
    """Load flax params (perturbed, so zero-initialized biases and unit
    scales are exercised too) into the port module; return the flax vars
    actually used."""
    rng = np.random.default_rng(perturb_seed)
    flat = {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in traverse_util.flatten_dict(flax_vars["params"],
                                                   sep=".").items()}
    module.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()},
                           strict=True)
    params = traverse_util.unflatten_dict(
        {tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()})
    return {"params": params}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _compare(jmod, tmod, x, atol=ATOL):
    v = _port(tmod, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jmod.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=atol)
    return got


@pytest.mark.parametrize("method",
                         ["conv_transpose", "conv_transpose_torch",
                          "resize_conv"])
def test_upsample(method):
    x = _x((2, 5, 6, 16))
    got = _compare(jl.UpsampleConv(8, method=method),
                   tl.UpsampleConv(16, 8, method=method), x)
    assert got.shape == (2, 10, 12, 8)


def test_conv_transpose_same_is_not_torch_convtranspose2d():
    """flax ConvTranspose(padding="SAME") is conv_transpose2d of the flipped
    kernel cropped to the first 2H x 2W, not ConvTranspose2d(3, 2, 1,
    output_padding=1) with or without the flip."""
    x = _x((1, 6, 6, 8), seed=3)
    m = tl.UpsampleConv(8, 8)
    v = _port(m, jl.UpsampleConv(8).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jl.UpsampleConv(8).apply(v, jnp.asarray(x)))
    k = m.ConvTranspose_0.kernel.detach()
    b = m.ConvTranspose_0.bias.detach()
    xn = torch.from_numpy(x).permute(0, 3, 1, 2)
    for w in (k.permute(2, 3, 0, 1), torch.flip(k, (0, 1)).permute(2, 3, 0, 1)):
        y = F.conv_transpose2d(xn, w, b, stride=2, padding=1, output_padding=1)
        assert np.abs(y.permute(0, 2, 3, 1).numpy() - ref).max() > 0.1


@pytest.mark.parametrize("cin,f,k,stride,pad,mode",
                         [(16, 32, 3, 2, 1, "zeros"),   # downsample
                          (3, 16, 7, 1, 3, "reflect"),  # stem
                          (16, 3, 7, 1, 3, "zeros")])   # head, zeros
def test_padconv(cin, f, k, stride, pad, mode):
    x = _x((2, 12, 12, cin))
    _compare(jl.PadConv(f, k, stride=stride, pad=pad, pad_mode=mode),
             tl.PadConv(cin, f, k, stride=stride, pad=pad, pad_mode=mode), x,
             atol=1e-4 if k == 7 else ATOL)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_resnet_block(pad_mode):
    x = _x((2, 8, 8, 16))
    _compare(jl.ResnetBlock(16, pad_mode=pad_mode),
             tl.ResnetBlock(16, pad_mode=pad_mode), x)


def test_instance_norm_module():
    x = _x((2, 6, 6, 8)) * 3 + 1
    _compare(jl.InstanceNorm(), tl.InstanceNorm(8), x)


def test_tpu_knobs_are_accepted_and_ignored():
    x = torch.from_numpy(_x((1, 8, 8, 8)))
    a = tl.PadConv(8, 8, 3, pad=1)
    b = tl.PadConv(8, 8, 3, pad=1, pad_impl="explicit", s2d_block=4,
                   dx_s2d=4, impl="pallas")
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        np.testing.assert_array_equal(a(x).numpy(), b(x).numpy())
    tl.ResnetBlock(8, convin=True, pad_impl="explicit")
    with pytest.raises(NotImplementedError):
        tl.ResnetBlock(8, norm="group")
