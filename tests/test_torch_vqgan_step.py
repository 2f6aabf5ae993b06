"""The port's VQGAN training step against the JAX ``VQGANTrainer``.

One initial state, the port's ``init_state`` (flax's initializers for the
generator), is carried into a JAX ``VQGANState`` (``make_mesh(1)``, fp32
compute) through ``uig_torch.convert``; both packages then take 3 steps on
the same
uint8 batches with the same crop offsets and flips (the port is given the
draws that the JAX step derives from its key). The small configuration is
that of ``tests/integration/test_vqgan.py`` (32² crops of 36² loads, base
16, mults (1, 2), embedding 8, codebook 32, attention at 16², a 2-layer
PatchGAN, batch 2 per domain, so a union batch of 4), with
``loss.vq_disc_start=1``: step 0 runs with D gated off (its parameters and
Adam state untouched), steps 1 and 2 with the hinge D update and the
adversarial term on, so the one JAX trainer covers both. The adaptive
weight is on (the preset's). The port runs on the CPU, single-threaded, so
that its rounding does not vary from run to run.

Tolerances, fp32 on both sides with sums in another order:
  * metrics (losses, ``lambda_adapt``, ``perplexity``, lr): rtol 1e-5;
  * gradients, per leaf: atol = 1e-5 * max|g_jax| over the network (the
    generator's, or D's). JAX's gradients are read from its Adam moments
    (mu_1 = g_1 / 2 with b1 = 0.5; g_k = 2 mu_k - mu_{k-1});
  * moments: atol = 1e-5 * max|m_jax| over the network;
  * parameters and EMA: atol 1e-6, excluding the parameter elements whose
    JAX gradient was below the gradient atol at some step (a conv bias
    before a GroupNorm of one channel per group has a true gradient of 0,
    and Adam turns its rounding noise into +-lr). The test prints how many
    elements it excluded.

A code whose two nearest codewords are within rounding of each other, or a
LeakyReLU or hinge input within rounding of 0, would take either side in
either package and move the gradients far beyond these tolerances; a few
gradients that are sums with heavy cancellation (the attention q bias)
sit near the 1e-5 bar. The batches come from ``DATA_SEED``, for which no
such element is hit in these three steps (of seeds 0-7, seeds 1, 2, 4, 5
and 6 run clean with the JAX step compiled as here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from uig.config import apply_overrides as jax_apply_overrides
from uig.config import get_preset as jax_get_preset
from uig.runtime import make_mesh
from uig.train.vqgan_trainer import VQGANTrainer as JaxTrainer
from uig_torch.config import apply_overrides, get_preset
from uig_torch.convert import (jax_flat_from_train_state,
                               train_state_from_jax_flat)
from uig_torch.train import VQGANState, VQGANTrainer

OVERRIDES = [
    "model.image_size=32", "data.load_size=36", "data.batch_size=2",
    "model.vq_base_features=16", "model.vq_channel_mults=(1,2)",
    "model.vq_embed_dim=8", "model.vq_codebook_size=32",
    "model.vq_attn_resolutions=(16,)", "model.d_layers=2",
    "model.compute_dtype=float32", "loss.lambda_lpips=0",
    "loss.vq_disc_start=1",
]
STEPS = 3
DISC_START = 1
DATA_SEED = 1  # see the module docstring
RTOL_LOSS = 1e-5
REL_GRAD = 1e-5
ATOL = 1e-6
B1 = 0.5


def _flat(state) -> dict:
    return {k: np.array(v) for k, v in traverse_util.flatten_dict(
        serialization.to_state_dict(state), sep="/").items()}


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _draws(rng, step, batch: int, load: int, crop: int):
    step_key = jax.random.fold_in(rng, step.astype(jnp.uint32))
    step_key = jax.random.fold_in(step_key, 0)  # axis index on make_mesh(1)
    out = []
    for key in jax.random.split(step_key, 2):
        k_off, k_flip = jax.random.split(key)
        oy = jax.random.randint(k_off, (batch,), 0, load - crop + 1)
        ox = jax.random.randint(jax.random.fold_in(k_off, 1), (batch,), 0,
                                load - crop + 1)
        out.append((oy, ox, jax.random.bernoulli(k_flip, 0.5, (batch,))))
    return out


def jax_draws(state, step: int, batch: int, load: int, crop: int) -> dict:
    """The crop offsets and flips of the JAX step (``vqgan_trainer.py``
    ``_device_step``, ``augment.py``), recomputed from its key."""
    draws = _draws(state.rng, jnp.asarray(step), batch, load, crop)
    return {name: tuple(torch.from_numpy(np.array(v)) for v in d)
            for name, d in zip(("aug_a", "aug_b"), draws)}


def _jax_state(jtr, flat: dict):
    """A JAX ``VQGANState`` holding ``flat``, placed as the step's output
    is (so that the jitted step compiles once)."""
    abstract = jax.eval_shape(jtr._abstract_state, jax.random.PRNGKey(0))
    nested = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    return jax.device_put(serialization.from_state_dict(abstract, nested),
                          jtr.state_shardings())


def run_both(data_seed: int) -> dict:
    jtr = JaxTrainer(jax_apply_overrides(jax_get_preset("vqgan512"),
                                         OVERRIDES), make_mesh(1))
    ptr = VQGANTrainer(apply_overrides(get_preset("vqgan512"), OVERRIDES),
                       device="cpu")
    init = jax_flat_from_train_state(ptr.init_state(0))
    init["rng"] = np.asarray(jax.random.PRNGKey(0))
    jstate = _jax_state(jtr, init)
    rng = np.random.default_rng(data_seed)
    batches = [tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                     for _ in range(2)) for _ in range(STEPS)]
    flat0 = _flat(jstate)
    pstate = train_state_from_jax_flat(flat0, VQGANState, seed=0)
    # the trainer's jitted step, compiled once with XLA's backend
    # optimization off: the same program, a third less compile time
    jax_step = jtr._train_step.lower(jstate, *batches[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    jax_flats, port_flats, jm, pm, pgrads = [], [], [], [], []
    threads = torch.get_num_threads()
    # one thread: PyTorch's multi-threaded CPU conv backward does not sum
    # in a fixed order, so its rounding would vary from process to process
    torch.set_num_threads(1)
    try:
        for step in range(STEPS):
            draws = jax_draws(jstate, step, 2, 36, 32)
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
            train_state_from_jax_flat(flat0, VQGANState, seed=0),
                                  batches[0], draws=draws0)
    finally:
        torch.set_num_threads(threads)
    return {"flat0": flat0, "jax": jax_flats, "port": port_flats,
            "jax_metrics": jm, "port_metrics": pm, "port_grads": pgrads,
            "train_step_1": jax_flat_from_train_state(whole)}


@pytest.fixture(scope="module")
def runs():
    return run_both(DATA_SEED)


def _first_update(opt: str) -> int:
    return DISC_START if opt == "d_opt" else 0


def _jax_grads(runs, opt: str, step: int) -> dict:
    """{leaf key under <opt>/0/0/mu/: JAX gradient at ``step`` (0-based)}."""
    pre = f"{opt}/0/0/mu/"
    mu = {k[len(pre):]: v for k, v in runs["jax"][step].items()
          if k.startswith(pre)}
    if step == _first_update(opt):
        return {k: v / (1.0 - B1) for k, v in mu.items()}
    prev = runs["jax"][step - 1]
    return {k: (v - B1 * prev[pre + k]) / (1.0 - B1) for k, v in mu.items()}


def _port_grads(runs, which: str, step: int) -> dict:
    tree = runs["port_grads"][step][which]
    return {f"params/{path.replace('.', '/')}": t.numpy()
            for path, t in tree.items()}


def _scale(tree: dict) -> float:
    return max(float(np.abs(v).max()) for v in tree.values())


def _tiny_grad_masks(runs, upto: int) -> dict:
    """{param key: elements whose JAX gradient fell below the gradient atol
    at some step <= upto}."""
    masks = {}
    for opt, tree in (("g_opt", "g_params"), ("d_opt", "d_params")):
        for step in range(_first_update(opt), upto + 1):
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
    assert got["lpips"] == 0.0
    assert (got["d_loss"] == 0.0) == (step < DISC_START)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("opt,which", [("g_opt", "g"), ("d_opt", "d")])
def test_gradients(runs, step, opt, which):
    if step < _first_update(opt):
        assert runs["port_grads"][step][which] is None  # D gated off
        return
    want = _jax_grads(runs, opt, step)
    got = _port_grads(runs, which, step)
    assert set(got) == set(want)
    atol = REL_GRAD * _scale(want)
    for k, g in want.items():
        _leaf_close(got[k], g, atol, f"step {step} grad {k}")


def test_gated_discriminator_is_untouched(runs):
    """Before ``vq_disc_start`` neither package moves D or its Adam state."""
    flat0 = runs["flat0"]
    for side in ("jax", "port"):
        after = runs[side][0]
        for k, v in flat0.items():
            if k.startswith(("d_params/", "d_opt/")):
                np.testing.assert_array_equal(after[k], v, err_msg=k)


@pytest.mark.parametrize("step", [0, STEPS - 1], ids=["1step", "3steps"])
def test_moments(runs, step):
    want, got = runs["jax"][step], runs["port"][step]
    for opt in ("g_opt", "d_opt"):
        for moment in ("mu", "nu"):
            pre = f"{opt}/0/0/{moment}/"
            leaves = {k: v for k, v in want.items() if k.startswith(pre)}
            atol = REL_GRAD * max(_scale(leaves), 1e-30)
            for k, v in leaves.items():
                _leaf_close(got[k], v, atol, k)
        count = max(0, step + 1 - _first_update(opt))
        for k in (f"{opt}/0/0/count", f"{opt}/0/1/count"):
            assert int(got[k]) == int(want[k]) == count, k


@pytest.mark.parametrize("step", [0, STEPS - 1], ids=["1step", "3steps"])
def test_params_and_ema(runs, step, capsys):
    want, got = runs["jax"][step], runs["port"][step]
    masks = _tiny_grad_masks(runs, step)
    excluded = total = 0
    for k, v in want.items():
        if k.startswith(("g_params/", "d_params/")):
            keep = ~masks.get(k, np.zeros(v.shape, bool))
            excluded += int((~keep).sum())
            total += keep.size
            _leaf_close(np.asarray(got[k])[keep], v[keep], ATOL, k)
        elif k.startswith("ema/"):
            _leaf_close(got[k], v, ATOL, k)
    assert int(got["step"]) == int(want["step"]) == step + 1
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
        train_state_from_jax_flat(flat0, VQGANState))
    assert set(back) == set(flat0)
    for k, v in flat0.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
