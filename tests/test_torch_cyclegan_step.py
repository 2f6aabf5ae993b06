"""The port's CycleGAN training step against the JAX ``CycleGANTrainer``.

One state, drawn by the port's ``init_state`` and placed into the structure
of JAX's ``CycleGANState`` (``jax_state_from_port``), is carried back into
the port through ``uig_torch.convert`` from JAX's own arrays (``make_mesh(1)``,
fp32 compute); both packages then take 3 steps on the same
uint8 batches with the same draws: the port is given the crop offsets,
flips, pool slots and coins that the JAX step derives from its key. The
small configuration crosses the pool's warmup boundary (pool 3, batch 2)
and the LR decay (total 4 steps, decay from step 1). The port runs on the
CPU, where every kernel wrapper takes its plain version.

Tolerances, fp32 on both sides (sums taken in another order):
  * losses and metrics: rtol 1e-5;
  * gradients, per leaf: atol = 1e-5 * max|g_jax|, the max taken over the
    network's whole gradient (the generators', or the discriminators'): a
    conv bias that feeds an instance norm has a true gradient of 0, so its
    computed values are rounding noise at the scale of the network's other
    gradients. JAX's gradients are read from its Adam moments (mu_1 = g_1 /
    2 exactly with b1 = 0.5; g_k = 2 mu_k - mu_{k-1});
  * moments, per leaf: atol = 1e-5 * max|m_jax| over the network;
  * parameters, EMA and pools: atol 1e-5, excluding the parameter elements
    whose JAX gradient was below the gradient atol at some step. Adam's
    first steps normalize every gradient to about +-1, so a gradient at
    rounding level may take either sign in either package, and its
    parameter then differs by up to 2 lr. The test prints how many
    elements it excluded.

A ReLU (or LeakyReLU) pre-activation that lands within rounding of 0 takes
either side in either package; its masked gradient then moves every
upstream gradient by far more than these tolerances. That is the same
function evaluated at a kink, not a fault, and a step of this size has
about a million such elements. The batches come from ``DATA_SEED``, for
which no such element is hit in these three steps (of seeds 0-11, seven
run clean); the comparison of the PyTorch side is single-threaded, so that
its rounding does not vary from run to run.

The state is drawn by the port rather than by JAX's ``init_state``, as
``tests/test_torch_vqgan_step.py`` does: that runs flax's initializers
eagerly, one XLA compile per op and parameter shape (about a minute on one
core), and the step's comparison needs only one state that both packages
hold. JAX's step is compiled once with XLA's backend optimization at
level 1: less compile time than the default, and, unlike level 0, code
that runs three steps in about a second.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from uig.config import apply_overrides as jax_apply_overrides
from uig.config import get_preset as jax_get_preset
from uig.runtime import make_mesh
from uig.train.cyclegan import CycleGANTrainer as JaxTrainer
from uig_torch.config import apply_overrides, get_preset
from uig_torch.convert import (jax_flat_from_train_state,
                               train_state_from_jax_flat)
from uig_torch.train import CycleGANState, CycleGANTrainer

OVERRIDES = [
    "model.image_size=32", "data.load_size=36", "data.batch_size=2",
    "model.g_base_features=8", "model.n_res_blocks=1",
    "model.d_base_features=8", "opt.pool_size=3", "opt.total_steps=4",
    "opt.decay_start_step=1", "model.compute_dtype=float32",
    "loss.lambda_lpips=0",
]
STEPS = 3
DATA_SEED = 3  # see the module docstring
RTOL_LOSS = 1e-5
REL_GRAD = 1e-5
ATOL = 1e-5
B1 = 0.5


def _flat(state) -> dict:
    return {k: np.array(v) for k, v in traverse_util.flatten_dict(
        serialization.to_state_dict(state), sep="/").items()}


def jax_draws(state, step: int, batch: int, load: int, crop: int,
              counts) -> dict:
    """The draws of the JAX step (``cyclegan.py:197-199``, ``augment.py``,
    ``pool.py``), recomputed from its key."""
    step_key = jax.random.fold_in(state.rng, jnp.asarray(step, jnp.uint32))
    step_key = jax.random.fold_in(step_key, 0)  # axis index on make_mesh(1)
    keys = dict(zip(("pool_a", "pool_b", "aug_a", "aug_b"),
                    jax.random.split(step_key, 4)))
    out = {}
    for name in ("aug_a", "aug_b"):
        k_off, k_flip = jax.random.split(keys[name])
        oy = jax.random.randint(k_off, (batch,), 0, load - crop + 1)
        ox = jax.random.randint(jax.random.fold_in(k_off, 1), (batch,), 0,
                                load - crop + 1)
        flip = jax.random.bernoulli(k_flip, 0.5, (batch,))
        out[name] = tuple(torch.from_numpy(np.array(v)) for v in (oy, ox, flip))
    for name, count in zip(("pool_a", "pool_b"), counts):
        k_idx, k_use = jax.random.split(keys[name])
        idx = jax.random.randint(k_idx, (batch,), 0, max(count, 1))
        use = jax.random.bernoulli(k_use, 0.5, (batch,))
        out[name] = (torch.from_numpy(np.array(idx)),
                     torch.from_numpy(np.array(use)))
    return out


def jax_state_from_port(jtr, port_state, key):
    """The port's state as JAX's ``CycleGANState`` on ``jtr``'s mesh: the
    structure and dtypes from ``jax.eval_shape`` of JAX's init (a trace, no
    compile), the values from ``jax_flat_from_train_state``, the key
    ``key``."""
    abstract = jax.eval_shape(jtr._abstract_state, key)
    flat = jax_flat_from_train_state(port_state)
    flat["rng"] = np.asarray(key)
    flat["ada_p"] = np.float32(jtr.cfg.loss.ada_p_init)
    tree = serialization.from_state_dict(abstract, traverse_util.unflatten_dict(
        flat, sep="/"))
    tree = jax.tree_util.tree_map(lambda a, v: np.asarray(v, a.dtype),
                                  abstract, tree)
    return jax.device_put(tree, jtr.state_shardings())


@pytest.fixture(scope="module")
def runs():
    jcfg = jax_apply_overrides(jax_get_preset("cyclegan256_dp"), OVERRIDES)
    jtr = JaxTrainer(jcfg, make_mesh(1))
    ptr = CycleGANTrainer(apply_overrides(get_preset("cyclegan256_dp"),
                                          OVERRIDES), device="cpu")
    jstate = jax_state_from_port(jtr, ptr.init_state(0),
                                 jax.random.PRNGKey(0))
    rng = np.random.default_rng(DATA_SEED)
    batches = [tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                     for _ in range(2)) for _ in range(STEPS)]
    flat0 = _flat(jstate)

    pstate = train_state_from_jax_flat(flat0, CycleGANState, seed=0)
    jax_flats, port_flats, jm, pm, pgrads = [], [], [], [], []
    # the trainer's jitted step, compiled once with XLA's backend
    # optimization at level 1: at level 0 the compile took 25.5 s and each
    # of the three steps ~7.8 s (unoptimized code), at level 1 37.5 s and
    # ~0.4 s a step (one core)
    jax_step = jtr._train_step.lower(jstate, *batches[0]).compile(
        compiler_options={"xla_backend_optimization_level": 1})
    threads = torch.get_num_threads()
    # one thread: PyTorch's multi-threaded CPU conv backward does not sum
    # in a fixed order, so its rounding would vary from process to process
    torch.set_num_threads(1)
    try:
        for step in range(STEPS):
            counts = (int(jstate.pool_a.count), int(jstate.pool_b.count))
            draws = jax_draws(jstate, step, 2, 36, 32, counts)
            if step == 0:
                draws0 = draws
            jstate, metrics = jax_step(jstate, *batches[step])
            jm.append({k: float(v) for k, v in metrics.items()})
            jax_flats.append(_flat(jstate))
            # train_step's two halves, so that the gradients can be read
            grads, metrics = ptr._grads(pstate, batches[step], draws)
            ptr._update(pstate, grads)
            pm.append({k: float(v) for k, v in metrics.items()})
            port_flats.append(jax_flat_from_train_state(pstate))
            pgrads.append(grads)
        whole, _ = ptr.train_step(
            train_state_from_jax_flat(flat0, CycleGANState, seed=0),
                                  batches[0], draws=draws0)
    finally:
        torch.set_num_threads(threads)
    return {"flat0": flat0, "jax": jax_flats, "port": port_flats,
            "jax_metrics": jm, "port_metrics": pm, "port_grads": pgrads,
            "train_step_1": jax_flat_from_train_state(whole)}


def _jax_grads(runs, opt: str, step: int) -> dict:
    """{leaf key under <opt>/0/0/mu/: JAX gradient at ``step`` (0-based)}."""
    pre = f"{opt}/0/0/mu/"
    mu = {k[len(pre):]: v for k, v in runs["jax"][step].items()
          if k.startswith(pre)}
    if step == 0:
        return {k: v / (1.0 - B1) for k, v in mu.items()}
    prev = runs["jax"][step - 1]
    return {k: (v - B1 * prev[pre + k]) / (1.0 - B1) for k, v in mu.items()}


def _port_grads(runs, which: str, step: int) -> dict:
    tree = runs["port_grads"][step][which]
    return {f"{name}/params/{path.replace('.', '/')}": t.numpy()
            for name, sub in tree.items() for path, t in sub.items()}


def _scale(tree: dict) -> float:
    return max(float(np.abs(v).max()) for v in tree.values())


def _tiny_grad_masks(runs, upto: int) -> dict:
    """{param key: elements whose JAX gradient fell below the gradient atol
    at some step <= upto}."""
    masks = {}
    for opt, tree in (("g_opt", "g_params"), ("d_opt", "d_params")):
        for step in range(upto + 1):
            grads = _jax_grads(runs, opt, step)
            atol = REL_GRAD * _scale(grads)
            for k, g in grads.items():
                key = f"{tree}/{k}"
                masks[key] = masks.get(key, False) | (np.abs(g) < atol)
    return masks


def _leaf_close(got, want, atol, what):
    err = np.abs(np.asarray(got, np.float64) - want)
    if err.size:
        assert err.max() <= atol, \
            f"{what}: max|err| {err.max():.3g} > {atol:.3g}"


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics(runs, step):
    want, got = runs["jax_metrics"][step], runs["port_metrics"][step]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_LOSS,
                                   atol=1e-7, err_msg=f"step {step} {k}")
    assert got["g_lpips"] == got["d_r1"] == 0.0


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("opt,which", [("g_opt", "g"), ("d_opt", "d")])
def test_gradients(runs, step, opt, which):
    want = _jax_grads(runs, opt, step)
    got = _port_grads(runs, which, step)
    assert set(got) == set(want)
    atol = REL_GRAD * _scale(want)
    for k, g in want.items():
        _leaf_close(got[k], g, atol, f"step {step} grad {k}")


@pytest.mark.parametrize("step", [0, STEPS - 1], ids=["1step", "3steps"])
def test_moments(runs, step):
    want, got = runs["jax"][step], runs["port"][step]
    for opt in ("g_opt", "d_opt"):
        for moment in ("mu", "nu"):
            pre = f"{opt}/0/0/{moment}/"
            leaves = {k: v for k, v in want.items() if k.startswith(pre)}
            atol = REL_GRAD * _scale(leaves)
            for k, v in leaves.items():
                _leaf_close(got[k], v, atol, k)
        for k in (f"{opt}/0/0/count", f"{opt}/0/1/count"):
            assert int(got[k]) == int(want[k]) == step + 1, k


@pytest.mark.parametrize("step", [0, STEPS - 1], ids=["1step", "3steps"])
def test_params_ema_pools(runs, step, capsys):
    want, got = runs["jax"][step], runs["port"][step]
    masks = _tiny_grad_masks(runs, step)
    excluded = total = 0
    for k, v in want.items():
        if k.startswith(("g_params/", "d_params/")):
            keep = ~masks[k]
            excluded += int((~keep).sum())
            total += keep.size
            _leaf_close(np.asarray(got[k])[keep], v[keep], ATOL, k)
        elif k.startswith(("ema/", "pool_")) and k.endswith(("kernel",
                                                             "bias", "scale",
                                                             "buffer")):
            _leaf_close(got[k], v, ATOL, k)
    assert int(got["step"]) == int(want["step"]) == step + 1
    for name in ("pool_a", "pool_b"):
        assert int(got[name + "/count"]) == int(want[name + "/count"])
    with capsys.disabled():
        print(f"\n[{step + 1} step(s)] parameter elements excluded for a "
              f"JAX gradient below atol: {excluded} of {total}")


def test_train_step_is_grads_then_update(runs):
    """``train_step`` gives, bit for bit, the state of its two halves."""
    want, got = runs["port"][0], runs["train_step_1"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_state_round_trip_is_bit_equal(runs):
    flat0 = runs["flat0"]
    back = jax_flat_from_train_state(
        train_state_from_jax_flat(flat0, CycleGANState, seed=0))
    assert set(back) == set(flat0)
    for k, v in flat0.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
