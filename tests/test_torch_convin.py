"""uig_torch.kernels.convin against the JAX fused conv3+IN (the Pallas
kernel in interpret mode). The port runs on the CPU, where the wrapper takes
its plain version. fp32; atol 1e-5 covers sums over 9*16 terms and 64 pixels
taken in another order. The gradients of the differentiable ``conv3_in_act``
(norm backward, then library dgrad/wgrad with the reflect ring folded) are
held against ``jax.vjp`` of the JAX function: dx within 1e-5; dw, db, dgamma
and dbeta (sums over the batch) within 1e-5 of the largest gradient of the
call, since the conv bias feeds the norm and its true gradient is 0.

The fp32 CUDA kernel multiplies in the three-term TF32 split on the tensor
cores; ``test_tf32x3_split_matches_pallas`` emulates its arithmetic in torch
(hi and lo TF32 parts of each operand, three products, partial sums over
the kernel's K depth added in fp32) and holds it to the same 1e-5 against
the Pallas kernel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention import _mm3
from uig.kernels.convin_pallas import conv3_in_act as jax_conv3_in_act
from uig_torch.kernels import conv3_in_act
from uig_torch.kernels.norm import instance_norm_reference

ATOL = 1e-5
# K stages (one tap's channels, at most 32) a partial sum in
# csrc/conv3_in_tf32.cu (UIG_K3_DEPTH)
K3_DEPTH = 2


def _compiled(fn, *args):
    """``fn(*args)`` under one ``jax.jit``, compiled with XLA's backend at
    optimization level 0 (the Pallas kernel in interpret mode compiles in
    a fraction of the time)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@functools.lru_cache(maxsize=None)
def _jax_forward(pad_mode, relu):
    """JAX's output on ``_inputs()``, computed once a mode."""
    return np.asarray(_compiled(
        lambda *a: jax_conv3_in_act(*a, relu=relu, pad_mode=pad_mode),
        *map(jnp.asarray, _inputs())))


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
    got = conv3_in_act(*map(torch.from_numpy, _inputs()), relu=relu,
                       pad_mode=pad_mode).numpy()
    ref = _jax_forward(pad_mode, relu)
    assert got.shape == ref.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_bad_pad_mode_and_shapes_raise():
    x, w, b, g, be = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="pad_mode"):
        conv3_in_act(x, w, b, g, be, relu=True, pad_mode="circular")
    with pytest.raises(ValueError, match="bad shapes"):
        conv3_in_act(x, w[:, :, :8], b, g, be, relu=True)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
@pytest.mark.parametrize("relu", [False, True])
def test_gradients_match_jax_vjp(pad_mode, relu):
    arrs = _inputs(seed=5)
    dy = np.random.default_rng(6).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y = conv3_in_act(*ins, relu=relu, pad_mode=pad_mode)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    def grads(dy, *a):
        _, vjp = jax.vjp(lambda *a: jax_conv3_in_act(*a, relu=relu,
                                                     pad_mode=pad_mode), *a)
        return vjp(dy)

    want = [np.asarray(v) for v in
            _compiled(grads, *map(jnp.asarray, (dy, *arrs)))]
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=ATOL)
    scale = max(np.abs(w).max() for w in want[1:])
    for name, u, v in zip(("dw", "db", "dgamma", "dbeta"), got[1:], want[1:]):
        np.testing.assert_allclose(u.numpy(), v, rtol=0, atol=ATOL * scale,
                                   err_msg=name)


def _conv3_tf32x3(x, w, b, pad_mode, depth=K3_DEPTH):
    """The conv + bias as the fp32 kernel forms it: K in stages of one
    tap's next 32 channels, each stage's products in the split, the stages
    summed in partials of ``depth`` and the partials added in K order."""
    nb, h, wd, c = x.shape
    mode = "reflect" if pad_mode == "reflect" else "constant"
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                 mode=mode).permute(0, 2, 3, 1)
    stages = [(xp[:, i:i + h, j:j + wd, c0:c0 + 32].reshape(-1, min(32, c - c0)),
               w[i, j, c0:c0 + 32]) for i in range(3) for j in range(3)
              for c0 in range(0, c, 32)]
    total = torch.zeros(nb * h * wd, w.shape[3])
    for k, (a, wk) in enumerate(stages):
        acc = _mm3(a, wk) if k % depth == 0 else acc + _mm3(a, wk)
        if k % depth == depth - 1 or k == len(stages) - 1:
            total = total + acc
    return (total + b).reshape(nb, h, wd, -1)


def test_tf32x3_split_matches_pallas():
    x, w, b, g, be = _inputs()
    yc = _conv3_tf32x3(*map(torch.from_numpy, (x, w, b)), "reflect")
    got = instance_norm_reference(yc, torch.from_numpy(g),
                                  torch.from_numpy(be), relu=True).numpy()
    np.testing.assert_allclose(got, _jax_forward("reflect", True), atol=ATOL)
