"""The port's DCLGAN training step (``dclgan256``'s recipe: the dual
PatchNCE, keys through the source generator and its heads and queries
through the other generator and its heads; lambda_nce 2 and the identity
L1 at an absolute weight of 1) against JAX's ``DCLGANTrainer``, fp32, from
one carried state with JAX's draws injected (crops, flips, both pools'
slots and coins, each tap's patch ids for NCE_a and NCE_b).

The port takes each NCE term's keys from the full apply that makes the
translation (``with_features``), the same function of the same parameters
as JAX's separate encoder apply, which XLA merges with it; the step check
holds that. Taps (4, 8) and tolerances as in
``tests/test_torch_cut_step.py`` (losses rtol 1e-5, gradients and moments
1e-5 of each network's largest, parameters, EMA and pools 1e-5 but the
elements whose JAX gradient is below the gradient tolerance). JAX's step is
compiled once with XLA's backend optimization off; the port runs
single-threaded on the CPU. Two tests, for the reason in
``tests/test_torch_cut_step.py``.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from uig.config import apply_overrides as jax_apply_overrides
from uig.config import get_preset as jax_get_preset
from uig.runtime import make_mesh
from uig.train.dclgan_trainer import DCLGANTrainer as JaxTrainer
from uig_torch.config import apply_overrides, get_preset
from uig_torch.convert import jax_flat_from_train_state
from uig_torch.train import DCLGANState, DCLGANTrainer

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


@pytest.fixture(scope="module")
def runs():
    jtr = JaxTrainer(jax_apply_overrides(jax_get_preset("dclgan256"),
                                         OVERRIDES), make_mesh(1))
    ptr = DCLGANTrainer(apply_overrides(get_preset("dclgan256"), OVERRIDES),
                        device="cpu")
    jstate = H.jax_state_from_port(jtr, ptr.init_state(0),
                                   jax.random.PRNGKey(0))
    rng = np.random.default_rng(DATA_SEED)
    batch = tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                  for _ in range(2))
    flat0 = H.flat(jstate)
    draws = H.dclgan_draws(ptr, jstate, 0, 2, 36)
    jax_step = jtr._train_step.lower(jstate, *batch).compile(
        compiler_options=H.JAX_OPTIONS)
    jstate, m = jax_step(jstate, *batch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pstate = H.port_state(flat0, DCLGANState)
        grads, pm = ptr._grads(pstate, batch, draws)
        ptr._update(pstate, grads)
    finally:
        torch.set_num_threads(threads)
    return {"jax": [H.flat(jstate)], "jm": {k: float(v) for k, v in m.items()},
            "pm": {k: float(v) for k, v in pm.items()}, "pg": grads,
            "port": jax_flat_from_train_state(pstate)}


def test_metrics_and_gradients(runs):
    H.check_metrics(runs["jm"], runs["pm"], "dclgan")
    assert runs["pm"]["g_idt"] > 0 and runs["pm"]["nce_b"] > 0
    for opt, which in (("g_opt", "g"), ("d_opt", "d")):
        got = H.port_grads(runs["pg"][which])
        if which == "g":  # both branches: generator and 2 heads (4 leaves)
            assert {k.split("/")[0] for k in got} == {"a2b", "b2a"}
            assert sum("/heads/" in k for k in got) == 2 * 2 * 4
        H.check_grads(H.jax_grads(runs["jax"], opt, 0), got, "dclgan")


def test_moments_params_ema_pools(runs):
    H.check_moments(runs["jax"][0], runs["port"])
    H.check_params_ema_pools(runs["jax"][0], runs["port"],
                             H.tiny_grad_masks(runs["jax"], 0))
    assert {k for k in runs["port"] if k.startswith("pool_") and
            k.endswith("buffer")} == {"pool_a/buffer", "pool_b/buffer"}
