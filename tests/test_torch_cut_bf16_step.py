"""The port's CUT training step in bf16 (``model.compute_dtype=bfloat16``,
the preset's default) against JAX's ``CUTTrainer`` in bf16, from one
carried state with JAX's draws injected; the port's fp32 step from the same
state is the yardstick for what bf16 itself moves, as in the CycleGAN and
VQGAN bf16 step files:

  * metrics within 2^-6 relative (a few bf16 ulps of each loss), as the
    CycleGAN file;
  * the replay pool, bf16 in both: closer to JAX's than the port's fp32
    step's, and within 2^-4 elementwise, as the CycleGAN file (read 0.0124
    of JAX's norm against fp32's 0.0139);
  * the gradients (read from JAX's Adam moments) and the parameters after
    Adam, per network (the generator with its heads, D), leaving out the
    generator conv biases that feed a norm (true gradient 0, rounding
    noise): the port's bf16 step within GAP = sqrt(2) times the distance
    of its fp32 step from JAX's bf16 step, in the Euclidean norm over the
    network, as ``tests/test_torch_vqgan_bf16_step.py``: a port that
    rounded at other places than JAX, with noise of the same size, would
    sit sqrt(2) times as far. The CycleGAN file's 1x does not hold here:
    PatchNCE's logits are cosines over a temperature of 0.07, which scales
    a one-ulp difference of a bf16 feature 14x before the softmax, and D's
    LeakyReLU kinks at batch 2 move its gradient by ~10 % for a 1 %
    change of the fakes (read: G 0.242 of JAX's norm against fp32's
    0.228, D 0.083 against 0.079, the parameters 1.29e-3 and 8.8e-4
    against 1.29e-3 and 8.2e-4). Refuses a zero G or D gradient.

The heads' Dense layers compute in bf16 with fp32 parameters in both
packages; PatchNCE is fp32 from its first cast. JAX's step keeps XLA's
default compile options (bits of a whole bf16 step move at level 0). Taps
(4, 8) as in ``tests/test_torch_cut_step.py``. The port runs single-threaded
on the CPU. Two tests, for the reason in ``tests/test_torch_cut_step.py``.
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
    "opt.decay_start_step=1", "model.compute_dtype=bfloat16",
    "parallel.multihost=false", "model.nce_layers=(4,8)",
    "model.nce_patches=16", "model.nce_proj_dim=16",
]
DATA_SEED = 3
RTOL_LOSS = 2.0 ** -6
POOL_ATOL = 2.0 ** -4
GAP = float(np.sqrt(2.0))


@pytest.fixture(scope="module")
def runs():
    jtr = JaxTrainer(jax_apply_overrides(jax_get_preset("cut256_multihost"),
                                         OVERRIDES), make_mesh(1))
    cfg = apply_overrides(get_preset("cut256_multihost"), OVERRIDES)
    port = {"bf16": CUTTrainer(cfg, device="cpu"),
            "fp32": CUTTrainer(apply_overrides(
                cfg, ["model.compute_dtype=float32"]), device="cpu")}
    jstate = H.jax_state_from_port(jtr, port["bf16"].init_state(0),
                                   jax.random.PRNGKey(0))
    rng = np.random.default_rng(DATA_SEED)
    batch = tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                  for _ in range(2))
    flat0 = H.flat(jstate)
    draws = H.cut_draws(port["bf16"], jstate, 0, 2, 36)
    jstate, m = jtr.train_step(jstate, batch)
    out = {"jax": [H.flat(jstate)], "jm": {k: float(v) for k, v in m.items()}}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for kind, tr in port.items():
            st = H.port_state(flat0, CUTState, pool_dtype=tr.dtype)
            grads, pm = tr._grads(st, batch, draws)
            tr._update(st, grads)
            out[kind] = {"pm": {k: float(v) for k, v in pm.items()},
                         "pg": grads, "flat": jax_flat_from_train_state(st),
                         "pool_dtype": st.pool_b.buffer.dtype}
    finally:
        torch.set_num_threads(threads)
    return out


def _norm_fed(keys, prefix: str = "") -> set:
    """The generator conv biases that feed an instance norm (every conv bias
    but the head's), keys ``<prefix>gen/params/layers_i/...``."""
    gen = [k for k in keys if k.startswith(prefix + "gen/")]
    depth = prefix.count("/") + 2
    head = max(int(k.split("/")[depth].split("_")[1]) for k in gen)
    return {k for k in gen if k.endswith("/bias")
            and k[:-len("bias")] + "kernel" in keys
            and k.split("/")[depth] != f"layers_{head}"}


def _dist(got: dict, want: dict) -> float:
    return float(np.sqrt(sum(
        np.sum((np.asarray(got[k], np.float64) - want[k]) ** 2)
        for k in want)))


def _closer(runs, want: dict, get, what: str, capsys, gap=GAP) -> None:
    """|get("bf16") - want| <= gap * |get("fp32") - want|, Euclidean."""
    d16, d32 = _dist(get("bf16"), want), _dist(get("fp32"), want)
    size = float(np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                             for v in want.values())))
    with capsys.disabled():
        print(f"\n{what}: |port bf16 - jax bf16| {d16 / size:.3e}, "
              f"|port fp32 - jax bf16| {d32 / size:.3e} (of |jax|)")
    assert d16 <= gap * d32, \
        f"{what}: bf16 gap {d16:.4g} > {gap:.3g} x fp32 gap {d32:.4g}"


def _grads_without_noise(runs, opt, which):
    want = H.jax_grads(runs["jax"], opt, 0)
    noise = _norm_fed(want) if which == "g" else set()
    assert which == "d" or len(noise) == 7  # stem, 2 down, 2 trunk, 2 up
    return {k: v for k, v in want.items() if k not in noise}


def test_metrics_and_pool(runs, capsys):
    want, got = runs["jm"], runs["bf16"]["pm"]
    assert set(got) == set(want)
    with capsys.disabled():
        print("\n" + ", ".join(f"{k} {got[k] / want[k] - 1:+.2e}"
                                for k in want if want[k]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_LOSS, atol=1e-6,
                                   err_msg=k)
    assert runs["bf16"]["pool_dtype"] == torch.bfloat16
    pool = {"pool_b/buffer": runs["jax"][0]["pool_b/buffer"]}
    flat = runs["bf16"]["flat"]
    np.testing.assert_allclose(flat["pool_b/buffer"], pool["pool_b/buffer"],
                               rtol=0, atol=POOL_ATOL)
    assert int(flat["pool_b/count"]) == int(runs["jax"][0]["pool_b/count"])
    _closer(runs, pool, lambda kind: {k: runs[kind]["flat"][k] for k in pool},
            "pool", capsys, gap=1.0)


def test_gradients_and_params_within_gap(runs, capsys):
    """Per network, the gradients and then the parameters and EMA after
    Adam; and the gate refuses a zero G or D gradient."""
    for opt, which in (("g_opt", "g"), ("d_opt", "d")):
        want = _grads_without_noise(runs, opt, which)
        _closer(runs, want,
                lambda kind: H.port_grads(runs[kind]["pg"][which]),
                f"{which} gradients", capsys)

        def zeroed(kind):
            got = H.port_grads(runs[kind]["pg"][which])
            return {k: 0 * got[k] for k in want} if kind == "bf16" else got

        with pytest.raises(AssertionError, match="bf16 gap"):
            _closer(runs, want, zeroed, f"zero {which} gradients", capsys)
    for tree in ("g_params", "d_params", "ema"):
        want = {k: v for k, v in runs["jax"][0].items()
                if k.startswith(tree + "/")}
        if tree == "g_params":
            want = {k: v for k, v in want.items()
                    if k not in _norm_fed(want, "g_params/")}
        elif tree == "ema":
            fed = _norm_fed({k.replace("ema/a2b/", "gen/", 1): 0
                             for k in want})
            want = {k: v for k, v in want.items()
                    if k.replace("ema/a2b/", "gen/", 1) not in fed}
        _closer(runs, want,
                lambda kind: {k: runs[kind]["flat"][k] for k in want},
                tree, capsys)
