"""The port's CycleGAN training step in bf16 against the JAX
``CycleGANTrainer`` in bf16 (``model.compute_dtype=bfloat16``, every
preset's default), from one carried state, with the same draws.

One state, drawn by the port's ``init_state`` and placed into JAX's
``CycleGANState`` as ``tests/test_torch_cyclegan_step.py`` does (JAX's own
eager init costs about a minute of compiles on one core), crosses from JAX
(``make_mesh(1)``) into the port through ``uig_torch.convert``: JAX's bf16
replay pools are widened to fp32 numpy arrays (exact) and held as bf16 by
the port. JAX's step keeps XLA's default compile options: with backend
optimization off its bf16 results move (the port's bf16 gap to it grew
from 0.205 to 0.216 of the G gradient). Both packages take ``STEPS``
steps on the same uint8 batches with the JAX step's crop offsets, flips,
pool slots and coins. The port also takes the same steps in fp32 from the
same state, the yardstick for what bf16 itself moves. The port runs on the
CPU (plain versions of every kernel), single-threaded so that its rounding
does not vary between processes.

bf16 rounds at other places in the two packages: JAX's XLA convs round the
conv and then add the bias in bf16, the port's K3 (and its plain version)
rounds ``acc + bias`` once; the reflect-padded stem runs as a zero-padded
conv plus a ring correction in JAX and as a conv of the reflect-padded
plane in the port; sums run in other orders. So an elementwise bound at
1e-5, as in fp32, does not apply. The checks, per network (generators,
discriminators) and step:
  * metrics: within ``RTOL_LOSS`` = 2^-6 relative (a few bf16 ulps of each
    loss, means over bf16 images);
  * gradients (read from JAX's Adam moments) and the parameters after Adam,
    leaving out the generator conv biases that feed a norm (``_norm_fed``):
    the port's bf16 step sits closer to JAX's bf16 step than the port's
    fp32 step does, in the Euclidean norm over the network: the port's bf16
    arithmetic is JAX's, not fp32's. A ReLU or LeakyReLU pre-activation
    that rounds to exactly 0 in bf16 takes either side in either package;
    a norm over the whole network absorbs those few elements, a max would
    not;
  * the replay pools, bf16 in both: the same criterion, and within
    ``POOL_ATOL`` = 2^-4 elementwise (fakes are tanh outputs in [-1, 1]).
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
    "opt.decay_start_step=1", "model.compute_dtype=bfloat16",
    "loss.lambda_lpips=0",
]
STEPS = 1
DATA_SEED = 3
RTOL_LOSS = 2.0 ** -6
POOL_ATOL = 2.0 ** -4
B1 = 0.5


def _flat(state) -> dict:
    """The JAX state as flat fp32 (or integer) numpy arrays: bf16 leaves
    widened, which is exact."""
    out = {}
    for k, v in traverse_util.flatten_dict(
            serialization.to_state_dict(state), sep="/").items():
        a = np.asarray(v)
        out[k] = a.astype(np.float32) if a.dtype.name == "bfloat16" else \
            np.array(a)
    return out


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
    structure and dtypes (bf16 pools) from ``jax.eval_shape`` of JAX's init
    (a trace, no compile), the values from ``jax_flat_from_train_state``,
    the key ``key``."""
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
    cfg = apply_overrides(get_preset("cyclegan256_dp"), OVERRIDES)
    port = {"bf16": CycleGANTrainer(cfg, device="cpu"),
            "fp32": CycleGANTrainer(apply_overrides(
                cfg, ["model.compute_dtype=float32"]), device="cpu")}
    jstate = jax_state_from_port(jtr, port["bf16"].init_state(0),
                                 jax.random.PRNGKey(0))
    rng = np.random.default_rng(DATA_SEED)
    batches = [tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                     for _ in range(2)) for _ in range(STEPS)]
    flat0 = _flat(jstate)
    states = {"bf16": train_state_from_jax_flat(flat0, CycleGANState,
                                                pool_dtype=torch.bfloat16),
              "fp32": train_state_from_jax_flat(flat0, CycleGANState)}
    out = {"jax": [], "jax_metrics": [],
           **{k: {"flat": [], "metrics": [], "grads": []} for k in port}}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for step in range(STEPS):
            counts = (int(jstate.pool_a.count), int(jstate.pool_b.count))
            draws = jax_draws(jstate, step, 2, 36, 32, counts)
            jstate, metrics = jtr.train_step(jstate, batches[step])
            out["jax_metrics"].append({k: float(v) for k, v in metrics.items()})
            out["jax"].append(_flat(jstate))
            for k, tr in port.items():
                grads, m = tr._grads(states[k], batches[step], draws)
                tr._update(states[k], grads)
                out[k]["metrics"].append({n: float(v) for n, v in m.items()})
                out[k]["flat"].append(jax_flat_from_train_state(states[k]))
                out[k]["grads"].append(grads)
    finally:
        torch.set_num_threads(threads)
    out["pool_dtype"] = states["bf16"].pool_a.buffer.dtype
    return out


def _jax_grads(runs, opt: str, step: int) -> dict:
    """{leaf key under <opt>/0/0/mu/: JAX gradient at ``step``}, from the
    fp32 moments: mu_1 = g_1 / 2 with b1 = 0.5; g_k = 2 mu_k - mu_{k-1}."""
    pre = f"{opt}/0/0/mu/"
    mu = {k[len(pre):]: v for k, v in runs["jax"][step].items()
          if k.startswith(pre)}
    if step == 0:
        return {k: v / (1.0 - B1) for k, v in mu.items()}
    prev = runs["jax"][step - 1]
    return {k: (v - B1 * prev[pre + k]) / (1.0 - B1) for k, v in mu.items()}


def _port_grads(runs, which: str, kind: str, step: int) -> dict:
    tree = runs[kind]["grads"][step][which]
    return {f"{name}/params/{path.replace('.', '/')}": t.numpy()
            for name, sub in tree.items() for path, t in sub.items()}


def _norm_fed(keys, prefix: str = "") -> set:
    """The generator conv biases followed by an instance norm (every conv
    bias but the head's), keys ``<prefix>a2b/params/layers_i/...``: their
    true gradient is 0, and both packages return rounding noise there (in
    bf16 JAX's is as large as real gradients, from its bf16 reduction), and
    Adam turns noise into +-lr. The comparisons leave them out."""
    gen = [k for k in keys if k.startswith((prefix + "a2b/", prefix + "b2a/"))]
    if not gen:
        return set()
    depth = prefix.count("/") + 2
    head = max(int(k.split("/")[depth].split("_")[1]) for k in gen)
    return {k for k in gen if k.endswith("/bias")
            and k[:-len("bias")] + "kernel" in keys
            and k.split("/")[depth] != f"layers_{head}"}


def _dist(got: dict, want: dict) -> float:
    assert set(want) <= set(got)
    return float(np.sqrt(sum(
        np.sum((np.asarray(got[k], np.float64) - want[k]) ** 2)
        for k in want)))


def _closer(runs, want: dict, get, what: str, capsys) -> None:
    d16, d32 = _dist(get("bf16"), want), _dist(get("fp32"), want)
    scale = float(np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                              for v in want.values())))
    with capsys.disabled():
        print(f"\n{what}: |port bf16 - jax bf16| {d16 / scale:.3e}, "
              f"|port fp32 - jax bf16| {d32 / scale:.3e} (of |jax|)")
    assert d16 <= d32, f"{what}: bf16 gap {d16:.4g} > fp32 gap {d32:.4g}"


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics(runs, step, capsys):
    want, got = runs["jax_metrics"][step], runs["bf16"]["metrics"][step]
    assert set(got) == set(want)
    with capsys.disabled():
        print("\n" + ", ".join(f"{k} {got[k] / want[k] - 1:+.2e}" for k in want
                                if want[k]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_LOSS,
                                   atol=1e-6, err_msg=f"step {step} {k}")


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("opt,which", [("g_opt", "g"), ("d_opt", "d")])
def test_gradients_closer_than_fp32(runs, step, opt, which, capsys):
    want = _jax_grads(runs, opt, step)
    noise = _norm_fed(want)
    assert which == "d" or len(noise) == 2 * 7  # stem, 2 down, 2 trunk, 2 up
    want = {k: v for k, v in want.items() if k not in noise}
    _closer(runs, want, lambda kind: _port_grads(runs, which, kind, step),
            f"step {step} {which} gradients", capsys)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("tree", ["g_params", "d_params", "ema"])
def test_params_closer_than_fp32(runs, step, tree, capsys):
    want = {k: v for k, v in runs["jax"][step].items()
            if k.startswith(tree + "/")}
    noise = _norm_fed(want, tree + "/")
    assert tree == "d_params" or len(noise) == 14
    want = {k: v for k, v in want.items() if k not in noise}
    _closer(runs, want, lambda kind: {k: runs[kind]["flat"][step][k]
                                      for k in want},
            f"step {step} {tree}", capsys)


@pytest.mark.parametrize("step", range(STEPS))
def test_pools(runs, step, capsys):
    assert runs["pool_dtype"] == torch.bfloat16
    want = {k: v for k, v in runs["jax"][step].items()
            if k.startswith("pool_") and k.endswith("/buffer")}
    got = runs["bf16"]["flat"][step]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=POOL_ATOL,
                                   err_msg=k)
        assert int(got[k.replace("buffer", "count")]) == \
            int(runs["jax"][step][k.replace("buffer", "count")])
    _closer(runs, want, lambda kind: {k: runs[kind]["flat"][step][k]
                                      for k in want},
            f"step {step} pools", capsys)
