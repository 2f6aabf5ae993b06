"""The port's CUT training step (the ``cut256_multihost`` recipe in one
process: PatchNCE with the identity term, no flip) against JAX's
``CUTTrainer``, fp32, from one carried state with JAX's draws injected
(crop offsets, flips, the pool's slots and coins, each tap's patch ids).

The state is drawn by the port's ``init_state`` and carried into JAX
(``tests/helpers/torch_contrastive.py``); both take ``STEPS`` steps on the same
uint8 batches. The taps (4, 8) read d128's norm before its ReLU (unfused in the
port, so K2b's backward takes the NCE gradient and the ReLU-masked one) and
d256's fused norm+ReLU, as the preset's taps 4 and 8 do; every other kind of
tap is held in ``tests/test_torch_cut.py`` (two taps keep JAX's compile to
~30 s on one core). The step also runs with ``model.fused_applies`` (JAX's
test holds its two paths equal, ``tests/unit/test_remat_and_api.py``), and
as ``train_step``.

Tolerances, as ``tests/test_torch_cyclegan_step.py``'s: losses rtol 1e-5;
gradients (read from JAX's Adam moments) per leaf within 1e-5 of the
network's largest (the generator and its heads, or D); moments likewise;
parameters, EMA and the pool within 1e-5, leaving out the parameter
elements whose JAX gradient fell below the gradient tolerance (Adam turns
rounding noise into +-lr). The port runs single-threaded on the CPU; JAX's
step is compiled once with XLA's backend optimization off (at level 0 it
compiles in ~23 s and runs a step in ~2.5 s on one core; level 1 takes ~39
s to compile). The file holds two tests: xdist's ``loadfile`` hands files
out in order of falling test count, so the JAX step files (this one, the
FastCUT, CUT bf16 and DCLGAN files) go after
``tests/integration/test_learning.py`` and run beside it.
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
    "parallel.multihost=false", "model.nce_layers=(4,8)",
    "model.nce_patches=16", "model.nce_proj_dim=16",
]
STEPS = 2
DATA_SEED = 3


@pytest.fixture(scope="module")
def runs():
    jtr = JaxTrainer(jax_apply_overrides(jax_get_preset("cut256_multihost"),
                                         OVERRIDES), make_mesh(1))
    cfg = apply_overrides(get_preset("cut256_multihost"), OVERRIDES)
    ptr = CUTTrainer(cfg, device="cpu")
    fused = CUTTrainer(apply_overrides(cfg, ["model.fused_applies=true"]),
                       device="cpu")
    jstate = H.jax_state_from_port(jtr, ptr.init_state(0),
                                   jax.random.PRNGKey(0))
    rng = np.random.default_rng(DATA_SEED)
    batches = [tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                     for _ in range(2)) for _ in range(STEPS)]
    flat0 = H.flat(jstate)
    pstate = H.port_state(flat0, CUTState)
    out = {"jax": [], "port": [], "jm": [], "pm": [], "pg": []}
    jax_step = jtr._train_step.lower(jstate, *batches[0]).compile(
        compiler_options=H.JAX_OPTIONS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for step in range(STEPS):
            draws = H.cut_draws(ptr, jstate, step, 2, 36)
            if step == 0:
                draws0 = draws
            jstate, m = jax_step(jstate, *batches[step])
            out["jm"].append({k: float(v) for k, v in m.items()})
            out["jax"].append(H.flat(jstate))
            grads, m = ptr._grads(pstate, batches[step], draws)
            ptr._update(pstate, grads)
            out["pm"].append({k: float(v) for k, v in m.items()})
            out["port"].append(jax_flat_from_train_state(pstate))
            out["pg"].append(grads)
        whole, _ = ptr.train_step(H.port_state(flat0, CUTState), batches[0],
                                  draws=draws0)
        out["train_step_1"] = jax_flat_from_train_state(whole)
        g, m = fused._grads(H.port_state(flat0, CUTState), batches[0], draws0)
        out["fused"] = (g, {k: float(v) for k, v in m.items()})
    finally:
        torch.set_num_threads(threads)
    return out


def test_steps_match_jax(runs, capsys):
    """Each step's metrics, gradients, moments, parameters, EMA and pool."""
    for step in range(STEPS):
        H.check_metrics(runs["jm"][step], runs["pm"][step], f"step {step}")
        assert runs["pm"][step]["nce_idt"] > 0
        for opt, which in (("g_opt", "g"), ("d_opt", "d")):
            got = H.port_grads(runs["pg"][step][which])
            if which == "g":  # the heads' gradients are part of G's
                assert sum(k.startswith("heads/") for k in got) == 2 * 4
            H.check_grads(H.jax_grads(runs["jax"], opt, step), got,
                          f"step {step}")
        H.check_moments(runs["jax"][step], runs["port"][step])
        excluded, total = H.check_params_ema_pools(
            runs["jax"][step], runs["port"][step],
            H.tiny_grad_masks(runs["jax"], step))
        with capsys.disabled():
            print(f"\n[{step + 1} step(s)] parameter elements excluded for "
                  f"a JAX gradient below atol: {excluded} of {total}")


def test_fused_applies_and_train_step(runs):
    """model.fused_applies batches the translation and identity applies,
    and the encoder passes, at 2B: the same function. ``train_step`` gives,
    bit for bit, the state of its two halves."""
    g, m = runs["fused"]
    H.check_metrics(runs["jm"][0], m, "fused")
    for which, opt in (("g", "g_opt"), ("d", "d_opt")):
        H.check_grads(H.jax_grads(runs["jax"], opt, 0), H.port_grads(g[which]),
                      f"fused {which}")
    want, got = runs["port"][0], runs["train_step_1"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
