"""The port's FastCUT training step (``fastcut256``'s recipe: PatchNCE
without the identity term, lambda_nce 10, flip equivariance) against JAX's
``CUTTrainer``, fp32, from one carried state, for both values of the flip
coin: the whole batch mirrored and the query features mirrored back along
W before matching, or neither. The coin is a draw of JAX's step key
(``fold_in(step_key, 0xF11)``); the state is carried into JAX under two
keys whose coins differ, and the port is given each step's draws.

One compile of JAX's step (XLA's backend optimization off) serves both keys;
one test a coin (two tests, for the reason in
``tests/test_torch_cut_step.py``). Taps (4, 8) and tolerances as in
``tests/test_torch_cut_step.py``, but the generator's gradients and moments
(and the Adam mask that follows them) at 2e-5 of the network's largest, not
1e-5: with lambda_nce 10 the stem kernel's gradient, a sum over every pixel of
the batch with large terms that cancel, sits near the 1e-5 line in JAX itself.
Two compiles of JAX's own step for the flipped coin, at backend optimization
level 0 and at XLA's default, differ there by 6.3e-6, 3.1e-6 and 9.0e-6 of the
largest G gradient for data seeds 3, 4 and 5; the port reads 1.2e-5, 5.6e-6 and
6.0e-6 from level 0 (1.4e-5, 5.4e-6, 9.9e-6 from the default), within twice
JAX's own gap. D keeps 1e-5."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from uig.config import apply_overrides as jax_apply_overrides
from uig.config import get_preset as jax_get_preset
from uig.runtime import make_mesh
from uig.train.cut import CUTTrainer as JaxTrainer
from uig_torch.config import apply_overrides, get_preset
from uig_torch.convert import jax_flat_from_train_state
from uig_torch.train import CUTState, CUTTrainer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "helpers"))
import torch_contrastive as H  # noqa: E402

OVERRIDES = [
    "model.image_size=32", "data.load_size=36", "data.batch_size=2",
    "model.g_base_features=8", "model.n_res_blocks=1",
    "model.d_base_features=8", "opt.pool_size=3", "opt.total_steps=4",
    "opt.decay_start_step=1", "model.compute_dtype=float32",
    "model.nce_layers=(4,8)", "model.nce_patches=16",
    "model.nce_proj_dim=16",
]
DATA_SEED = 3
COINS = (True, False)
REL_G = 2e-5  # see the module docstring


def _key_with_coin(coin: bool, state):
    for k in range(64):
        key = jax.random.PRNGKey(k)
        if H.flip_coin(state.replace(rng=key), 0) == coin:
            return key
    raise AssertionError("no key with that coin")


@pytest.fixture(scope="module")
def runs():
    jtr = JaxTrainer(jax_apply_overrides(jax_get_preset("fastcut256"),
                                         OVERRIDES), make_mesh(1))
    ptr = CUTTrainer(apply_overrides(get_preset("fastcut256"), OVERRIDES),
                     device="cpu")
    base = H.jax_state_from_port(jtr, ptr.init_state(0),
                                 jax.random.PRNGKey(0))
    rng = np.random.default_rng(DATA_SEED)
    batch = tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                  for _ in range(2))
    jax_step = None
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for coin in COINS:
            jstate = H.jax_state_from_port(jtr, H.port_state(
                H.flat(base), CUTState), _key_with_coin(coin, base))
            if jax_step is None:
                jax_step = jtr._train_step.lower(jstate, *batch).compile(
                    compiler_options=H.JAX_OPTIONS)
            flat0 = H.flat(jstate)
            draws = H.cut_draws(ptr, jstate, 0, 2, 36)
            assert draws["flip"] is coin and "nce_idt" not in draws
            jstate, m = jax_step(jstate, *batch)
            pstate = H.port_state(flat0, CUTState)
            grads, pm = ptr._grads(pstate, batch, draws)
            ptr._update(pstate, grads)
            out[coin] = {"jax": [H.flat(jstate)],
                         "jm": {k: float(v) for k, v in m.items()},
                         "pm": {k: float(v) for k, v in pm.items()},
                         "pg": grads,
                         "port": jax_flat_from_train_state(pstate)}
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("coin", COINS, ids=["flipped", "unflipped"])
def test_step_matches_jax(runs, coin):
    """The metrics, gradients, moments, parameters, EMA and pool of the
    step with each coin; the coin changes the step (the flip is no
    no-op)."""
    r = runs[coin]
    H.check_metrics(r["jm"], r["pm"], f"coin {coin}")
    assert r["pm"]["nce_idt"] == 0.0
    for opt, which in (("g_opt", "g"), ("d_opt", "d")):
        H.check_grads(H.jax_grads(r["jax"], opt, 0),
                      H.port_grads(r["pg"][which]), f"coin {coin}",
                      REL_G if which == "g" else H.REL_GRAD)
    H.check_moments(r["jax"][0], r["port"], REL_G)
    H.check_params_ema_pools(r["jax"][0], r["port"],
                             H.tiny_grad_masks(r["jax"], 0, REL_G))
    assert runs[True]["pm"]["nce"] != runs[False]["pm"]["nce"]
