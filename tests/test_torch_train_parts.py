"""The pieces of the port's training step against their JAX functions, on
the CPU, fp32, with inputs made from a seed with numpy:

* losses (``gan_loss_g``/``gan_loss_d`` in all four modes, one map and a
  tuple of maps; ``cycle_loss``, ``identity_loss``): rtol 1e-6;
* ``lr_schedule`` (linear, cosine, constant, each with and without warmup):
  rtol 1e-6 (both evaluate in fp32);
* ``Adam`` against ``make_optimizer``'s optax chain over 3 steps of a
  decaying schedule: parameters and moments within 1e-7 (an fp32 ulp at
  these magnitudes; the same operations in the same order);
* ``ema_update``: bit-equal;
* ``ImagePool.query`` with a slot targeted twice, given the JAX draws:
  bit-equal buffer, output and count;
* the reflect pad's fixed-order adjoint against PyTorch's own;
* the per-step generator, and the trainer's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from uig.config import OptConfig as JaxOptConfig
from uig.train import losses as JL
from uig.train.ema import ema_update as jax_ema_update
from uig.train.pool import ImagePool as JaxPool
from uig.train.pool import PoolState as JaxPoolState
from uig.train.state import lr_schedule as jax_lr_schedule
from uig.train.state import make_optimizer
from uig_torch.config import OptConfig, apply_overrides, get_preset
from uig_torch.kernels.reflect import reflect_fold, reflect_pad
from uig_torch.runtime.prng import step_generator
from uig_torch.train import CycleGANTrainer
from uig_torch.train import losses as L
from uig_torch.train.ema import ema_update
from uig_torch.train.pool import ImagePool, PoolState
from uig_torch.train.state import Adam, lr_schedule


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "hinge", "wgan"])
@pytest.mark.parametrize("multi", [False, True])
def test_gan_losses(mode, multi):
    r, f = _rand(2, 4, 4, 1, seed=1), _rand(2, 4, 4, 1, seed=2)
    if multi:
        r2, f2 = _rand(2, 2, 2, 1, seed=3), _rand(2, 2, 2, 1, seed=4)
        jr, jf = (jnp.asarray(r), jnp.asarray(r2)), (jnp.asarray(f),
                                                     jnp.asarray(f2))
        tr = (torch.from_numpy(r), torch.from_numpy(r2))
        tf = (torch.from_numpy(f), torch.from_numpy(f2))
    else:
        jr, jf = jnp.asarray(r), jnp.asarray(f)
        tr, tf = torch.from_numpy(r), torch.from_numpy(f)
    np.testing.assert_allclose(float(L.gan_loss_g(tf, mode)),
                               float(JL.gan_loss_g(jf, mode)), rtol=1e-6)
    np.testing.assert_allclose(float(L.gan_loss_d(tr, tf, mode)),
                               float(JL.gan_loss_d(jr, jf, mode)), rtol=1e-6)


def test_l1_losses_and_bad_mode():
    a, b = _rand(2, 8, 8, 3, seed=5), _rand(2, 8, 8, 3, seed=6)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(L.cycle_loss(ta, tb)),
                               float(JL.cycle_loss(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(L.identity_loss(ta, tb)),
                               float(JL.identity_loss(a, b)), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown gan mode"):
        L.gan_loss_g(ta, "softmax")


@pytest.mark.parametrize("kind", ["linear", "cosine", "constant"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule(kind, warmup):
    kw = dict(lr=2e-4, total_steps=10, decay_start_step=4, lr_decay=kind,
              warmup_steps=warmup)
    ours = lr_schedule(OptConfig(**kw), 0.5)
    theirs = jax_lr_schedule(JaxOptConfig(**kw), 0.5)
    for step in range(12):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, atol=0, err_msg=str(step))
    with pytest.raises(ValueError, match="lr_decay"):
        lr_schedule(OptConfig(lr_decay="step"))


def test_adam_matches_optax():
    kw = dict(total_steps=4, decay_start_step=1, lr=2e-3)
    shapes = {"a": {"w": (3, 4), "b": (4,)}, "b": {"w": (5,)}}
    params = {n: {k: _rand(*s, seed=10 + i) for i, (k, s) in
                  enumerate(sub.items())} for n, sub in shapes.items()}
    tx = make_optimizer(JaxOptConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    adam = Adam(OptConfig(**kw))
    tparams = {n: {k: torch.from_numpy(v.copy()) for k, v in sub.items()}
               for n, sub in params.items()}
    tstate = adam.init(tparams)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p, s=step: _rand(*p.shape, seed=100 + s + p.size,
                                    scale=10.0 ** (s - 2)), params)
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        leaves = [torch.from_numpy(grads[n][k]) for n in sorted(grads)
                  for k in sorted(grads[n])]
        adam.update(tparams, leaves, tstate)
        assert tstate.count == int(jstate[0][0].count) == step + 1
        for n, sub in tparams.items():
            for k, t in sub.items():
                for got, want in ((t, jparams[n][k]),
                                  (tstate.mu[n][k], jstate[0][0].mu[n][k]),
                                  (tstate.nu[n][k], jstate[0][0].nu[n][k])):
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("field,value", [("grad_clip", 1.0),
                                         ("weight_decay", 0.01),
                                         ("optimizer", "sgd")])
def test_adam_refuses_unported_options(field, value):
    with pytest.raises(NotImplementedError):
        Adam(OptConfig(**{field: value}))


def test_ema_update_is_bit_equal():
    ema = {"a": {"w": _rand(4, 5, seed=20)}, "b": {"w": _rand(3, seed=21)}}
    new = {"a": {"w": _rand(4, 5, seed=22)}, "b": {"w": _rand(3, seed=23)}}
    want = jax_ema_update(jax.tree_util.tree_map(jnp.asarray, ema),
                          jax.tree_util.tree_map(jnp.asarray, new), 0.999)
    tema = {n: {k: torch.from_numpy(v.copy()) for k, v in s.items()}
            for n, s in ema.items()}
    tnew = {n: {k: torch.from_numpy(v) for k, v in s.items()}
            for n, s in new.items()}
    ema_update(tema, tnew, 0.999)
    for n in ema:
        np.testing.assert_array_equal(tema[n]["w"].numpy(),
                                      np.asarray(want[n]["w"]))


def _pool_key_with_duplicate(count, b):
    """A key whose draws write one pool slot twice (the pool is full)."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        k_idx, k_use = jax.random.split(key)
        idx = np.array(jax.random.randint(k_idx, (b,), 0, max(count, 1)))
        use = np.array(jax.random.bernoulli(k_use, 0.5, (b,)))
        written = idx[use]
        if len(written) != len(set(written.tolist())):
            return key, idx, use
    raise AssertionError("no key with a duplicate slot")


@pytest.mark.parametrize("count", [3, 1])
def test_pool_query_matches_jax(count):
    size, b = 3, 4
    buf = _rand(size, 4, 4, 3, seed=30)
    buf[count:] = 0
    fakes = _rand(b, 4, 4, 3, seed=31)
    if count == size:
        key, idx, use = _pool_key_with_duplicate(count, b)
    else:  # straddles the warmup boundary
        key = jax.random.PRNGKey(7)
        k_idx, k_use = jax.random.split(key)
        idx = np.array(jax.random.randint(k_idx, (b,), 0, count))
        use = np.array(jax.random.bernoulli(k_use, 0.5, (b,)))
    jstate, jout = JaxPool(size).query(
        JaxPoolState(jnp.asarray(buf), jnp.asarray(count, jnp.int32)),
        jnp.asarray(fakes), key)
    state, out = ImagePool(size).query(
        PoolState(torch.from_numpy(buf.copy()), count),
        torch.from_numpy(fakes), torch.from_numpy(idx),
        torch.from_numpy(use))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(state.buffer.numpy(),
                                  np.asarray(jstate.buffer))
    assert state.count == int(jstate.count)


def test_pool_off_passes_fakes_through():
    fakes = torch.ones(2, 4, 4, 3)
    state = PoolState(torch.zeros(0, 4, 4, 3), 0)
    assert ImagePool(0).query(state, fakes, [0, 0], [True, True])[1] is fakes


@pytest.mark.parametrize("p,shape", [(3, (2, 9, 7, 4)), (1, (1, 4, 5, 2)),
                                     (3, (1, 4, 4, 1))])
def test_reflect_pad_adjoint_matches_torch(p, shape):
    x = torch.from_numpy(_rand(*shape, seed=40)).requires_grad_(True)
    ct = torch.from_numpy(_rand(shape[0], shape[1] + 2 * p,
                                shape[2] + 2 * p, shape[3], seed=41))
    y = reflect_pad(x, p)
    want = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                 mode="reflect").permute(0, 2, 3, 1)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    got, = torch.autograd.grad(y, x, ct)
    ref, = torch.autograd.grad(want, x, ct)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(reflect_fold(ct, p), got, rtol=0, atol=0)


def test_step_generator_depends_on_seed_and_step_only():
    def draw(seed, step):
        return torch.rand(4, generator=step_generator(seed, step))

    assert torch.equal(draw(0, 5), draw(0, 5))
    assert not torch.equal(draw(0, 5), draw(0, 6))
    assert not torch.equal(draw(0, 5), draw(1, 5))


_SMALL = ["model.image_size=32", "data.load_size=36", "data.batch_size=2",
          "model.g_base_features=8", "model.n_res_blocks=1",
          "model.d_base_features=8", "model.compute_dtype=float32",
          "loss.lambda_lpips=0"]


@pytest.mark.parametrize("override,match", [
    ("model.norm=batch", "norm"),
    ("loss.r1_gamma=1.0", "r1_gamma"),
    ("loss.ada_target=0.6", "ADA"),
    ("opt.grad_accum=2", "grad_accum"),
    ("opt.weight_decay=0.1", "weight_decay"),
    ("opt.grad_clip=1.0", "grad_clip"),
])
def test_trainer_refuses_unported(override, match):
    cfg = apply_overrides(get_preset("cyclegan256_dp"), _SMALL + [override])
    with pytest.raises(NotImplementedError, match=match):
        CycleGANTrainer(cfg, device="cpu")


def test_trainer_needs_the_card_unless_asked_for_the_cpu():
    cfg = apply_overrides(get_preset("cyclegan256_dp"), _SMALL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CycleGANTrainer(cfg)
    tr = CycleGANTrainer(cfg, device="cpu")
    state = tr.init_state(0)
    assert state.step == 0 and state.pool_a.count == 0
    x = torch.zeros(1, 32, 32, 3)
    assert tr.translate(state.ema, x, "b2a").shape == (1, 32, 32, 3)
    with pytest.raises(ValueError, match="direction"):
        tr.translate(state.ema, x, "c2d")


def test_unfused_applies_and_center_crop_run_the_same_step():
    """fused_applies batches the fake and identity passes (and D's real and
    fake passes) at 2B; instance norm is per example, so the step is the
    same function. data.augment=none center-crops instead of drawing."""
    rng = np.random.default_rng(50)
    a, b = (rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
            for _ in range(2))
    runs = {}
    for name, extra in (("fused", []),
                        ("unfused", ["model.fused_applies=false"])):
        cfg = apply_overrides(get_preset("cyclegan256_dp"), _SMALL + extra)
        tr = CycleGANTrainer(cfg, device="cpu")
        state = tr.init_state(1)
        state, m = tr.train_step(state, (a, b), tr.draw(state, 2, 36, 36))
        runs[name] = (state, m)
    (s1, m1), (s2, m2) = runs["fused"], runs["unfused"]
    for k in m1:
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(s2.pool_a.buffer.numpy(),
                               s1.pool_a.buffer.numpy(), atol=1e-5)
    cfg = apply_overrides(get_preset("cyclegan256_dp"),
                          _SMALL + ["data.augment=none"])
    tr = CycleGANTrainer(cfg, device="cpu")
    crop = tr._input(a, None)
    np.testing.assert_array_equal(
        crop.numpy(), (a[:, 2:34, 2:34].astype(np.float32) * np.float32(
            2.0 / 255.0) - np.float32(1.0)))
