"""Carry module weights (generators, LPIPS's VGG), and whole CycleGAN and
VQGAN train states, between the JAX package's layout and the port; and draw
weights in that layout from a seed by flax's initializers.

The flat flax layout is the one ``scripts/import_cyclegan_torch.py`` writes
and reads: ``np.savez`` of keys like ``params/layers_0/kernel`` and
``params/layers_9/PadConv_0/bias``. The port keeps flax's parameter names
and layouts (conv kernels HWIO), so a key maps to the port's
``layers_0.kernel`` by a rename and every array crosses unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_PREFIX = "params/"


def generator_state_from_flax(flat: dict[str, np.ndarray],
                              model: nn.Module | None = None
                              ) -> dict[str, torch.Tensor]:
    """Flat flax keys of one module (a generator, or LPIPS's
    ``VGG16Features``) -> the port's state dict (fp32 CPU tensors). With
    ``model``, raises KeyError on any missing or unused key and ValueError
    on a shape that differs."""
    state = {}
    for key, value in flat.items():
        if not key.startswith(_PREFIX):
            raise KeyError(f"flax key {key!r} does not start with {_PREFIX!r}")
        name = key[len(_PREFIX):].replace("/", ".")
        state[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    if model is not None:
        check_state(state, model)
    return state


def flax_from_generator_state(state: dict[str, torch.Tensor]
                              ) -> dict[str, np.ndarray]:
    """The inverse: the port's state dict -> flat flax keys (numpy fp32)."""
    return {_PREFIX + name.replace(".", "/"):
            t.detach().to("cpu", torch.float32).numpy()
            for name, t in state.items()}


def check_state(state: dict[str, torch.Tensor], model: nn.Module) -> None:
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    unused = sorted(set(state) - set(expected))
    if missing or unused:
        raise KeyError(f"generator weights do not match the model: missing "
                       f"{missing}, unused {unused}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{name}: weights have shape {tuple(t.shape)}, "
                             f"model wants {tuple(expected[name].shape)}")


def load_generator_npz(path: str) -> dict[str, np.ndarray]:
    """Read the flat flax ``.npz`` of one generator (``params/...`` keys)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the whole CycleGAN train state
# ---------------------------------------------------------------------------
# A JAX ``CycleGANState`` crosses as a flat dict of numpy arrays: flax's
# ``serialization.to_state_dict`` of the state, flattened with "/". Its keys:
#   g_params/{a2b,b2a}/params/<path>       d_params/{a,b}/params/<path>
#   ema/{a2b,b2a}/params/<path>
#   {g,d}_opt/0/0/count, .../0/0/mu/<tree>/params/<path>, .../0/0/nu/...
#       (optax.chain(optax.adam): ScaleByAdamState), {g,d}_opt/0/1/count
#       (the learning-rate schedule's count, equal to Adam's)
#   pool_{a,b}/buffer, pool_{a,b}/count, step, rng, ada_p
# <path> is flax's module path ("layers_9/PadConv_0/kernel"); the port's
# parameter name is the same path with dots.

_TREES = {"g_params": ("a2b", "b2a"), "d_params": ("a", "b"),
          "ema": ("a2b", "b2a")}
_ADAM = "/0/0/"
_SCHED = "/0/1/count"


def _tree_from_flat(flat: dict, prefix: str, names, device) -> dict:
    out = {n: {} for n in names}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        name, rest = key[len(prefix):].split("/", 1)
        if not rest.startswith(_PREFIX):
            raise KeyError(f"{key!r}: expected {prefix}{name}/{_PREFIX}...")
        out[name][rest[len(_PREFIX):].replace("/", ".")] = torch.from_numpy(
            np.array(value, dtype=np.float32)).to(device)
    return out


def _flat_from_tree(tree: dict, prefix: str) -> dict:
    out = {}
    for name, sub in tree.items():
        out.update(_flat_from_params(sub, f"{prefix}{name}/{_PREFIX}"))
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """An fp32 numpy copy (never a view of a tensor a later step updates);
    exact for bf16 tensors."""
    return np.array(t.detach().to(torch.float32).cpu(), dtype=np.float32)


def state_from_jax_flat(flat: dict[str, np.ndarray], seed: int = 0,
                        device="cpu", pool_dtype=torch.float32):
    """A flat JAX ``CycleGANState`` -> the port's ``CycleGANState`` on
    ``device``. ``seed`` seeds the port's own per-step draws (the JAX key
    cannot be carried over and is kept in ``carried`` unchanged). The
    replay pools hold the compute dtype, ``pool_dtype``; a bf16 pool crosses
    as fp32 arrays (exact), which the caller widens from JAX's bf16."""
    from uig_torch.train.pool import PoolState
    from uig_torch.train.state import AdamState, CycleGANState

    trees = {k: _tree_from_flat(flat, k + "/", names, device)
             for k, names in _TREES.items()}

    def adam(opt: str, names) -> AdamState:
        count = int(flat[opt + _ADAM + "count"])
        sched = int(flat[opt + _SCHED])
        if sched != count:
            raise ValueError(f"{opt}: schedule count {sched} != Adam count "
                             f"{count}")
        return AdamState(
            count, _tree_from_flat(flat, opt + _ADAM + "mu/", names, device),
            _tree_from_flat(flat, opt + _ADAM + "nu/", names, device))

    def pool(name: str) -> PoolState:
        return PoolState(torch.from_numpy(np.array(
            flat[name + "/buffer"], dtype=np.float32)).to(device, pool_dtype),
            int(flat[name + "/count"]))

    carried = {k: np.asarray(flat[k]) for k in ("rng", "ada_p") if k in flat}
    return CycleGANState(
        g_params=trees["g_params"], d_params=trees["d_params"],
        g_opt=adam("g_opt", _TREES["g_params"]),
        d_opt=adam("d_opt", _TREES["d_params"]), ema=trees["ema"],
        pool_a=pool("pool_a"), pool_b=pool("pool_b"),
        step=int(flat["step"]), seed=int(seed), carried=carried)


def jax_flat_from_state(state) -> dict[str, np.ndarray]:
    """The inverse of ``state_from_jax_flat``: numpy arrays under the JAX
    state's flat keys (counts and step as int32)."""
    flat = {}
    for k in _TREES:
        flat.update(_flat_from_tree(getattr(state, k), k + "/"))
    for opt, st in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        flat.update(_flat_from_tree(st.mu, opt + _ADAM + "mu/"))
        flat.update(_flat_from_tree(st.nu, opt + _ADAM + "nu/"))
        flat[opt + _ADAM + "count"] = np.int32(st.count)
        flat[opt + _SCHED] = np.int32(st.count)
    for name in ("pool_a", "pool_b"):
        p = getattr(state, name)
        flat[name + "/buffer"] = _numpy(p.buffer)
        flat[name + "/count"] = np.int32(p.count)
    flat["step"] = np.int32(state.step)
    flat.update(state.carried)
    return flat


# ---------------------------------------------------------------------------
# VQGAN: seeded weights and the whole train state
# ---------------------------------------------------------------------------
# A JAX ``VQGANState`` crosses as a flat dict as the CycleGAN state does. One
# generator and one discriminator, so no network name after the tree:
#   g_params/params/<path>    d_params/params/<path>    ema/a2b/params/<path>
#   {g,d}_opt/0/0/count, {g,d}_opt/0/0/{mu,nu}/params/<path>,
#   {g,d}_opt/0/1/count       rng, step


def seeded_flax(model: nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Flat flax-layout weights for ``model`` (a ``VQGANGenerator``, or
    LPIPS's ``VGG16Features``), drawn with numpy from ``seed`` by flax's
    default initializers: conv kernels
    lecun-normal (a normal truncated at 2 sigma, scaled to variance
    1 / fan_in with fan_in = kh * kw * cin), zero biases, unit GroupNorm
    scales, and the codebook ``variance_scaling(1, "fan_in", "uniform")``,
    uniform within +-sqrt(3 / K)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".kernel"):
            v = rng.standard_normal(shape)
            while (bad := np.abs(v) > 2.0).any():
                v[bad] = rng.standard_normal(int(bad.sum()))
            v *= np.sqrt(1.0 / np.prod(shape[:-1])) / 0.87962566103423978
        elif name.endswith(".codebook"):
            lim = np.sqrt(3.0 / shape[0])
            v = rng.uniform(-lim, lim, shape)
        elif name.endswith(".scale"):
            v = np.ones(shape)
        else:
            v = np.zeros(shape)
        flat[_PREFIX + name.replace(".", "/")] = v.astype(np.float32)
    return flat


def _params_from_flat(flat: dict, prefix: str, device) -> dict:
    return {k[len(prefix):].replace("/", "."): torch.from_numpy(
        np.array(v, dtype=np.float32)).to(device)
        for k, v in flat.items() if k.startswith(prefix)}


def _flat_from_params(params: dict, prefix: str) -> dict:
    return {prefix + name.replace(".", "/"): _numpy(t)
            for name, t in params.items()}


def vqgan_state_from_jax_flat(flat: dict[str, np.ndarray], seed: int = 0,
                              device="cpu"):
    """A flat JAX ``VQGANState`` -> the port's ``VQGANState`` on ``device``;
    ``seed`` seeds the port's own draws (the JAX key stays in
    ``carried``)."""
    from uig_torch.train.state import AdamState, VQGANState

    def adam(opt: str) -> AdamState:
        count = int(flat[opt + _ADAM + "count"])
        if int(flat[opt + _SCHED]) != count:
            raise ValueError(f"{opt}: schedule count {int(flat[opt + _SCHED])}"
                             f" != Adam count {count}")
        return AdamState(
            count,
            _params_from_flat(flat, opt + _ADAM + "mu/" + _PREFIX, device),
            _params_from_flat(flat, opt + _ADAM + "nu/" + _PREFIX, device))

    carried = {k: np.asarray(flat[k]) for k in ("rng",) if k in flat}
    return VQGANState(
        g_params=_params_from_flat(flat, "g_params/" + _PREFIX, device),
        d_params=_params_from_flat(flat, "d_params/" + _PREFIX, device),
        g_opt=adam("g_opt"), d_opt=adam("d_opt"),
        ema={"a2b": _params_from_flat(flat, "ema/a2b/" + _PREFIX, device)},
        step=int(flat["step"]), seed=int(seed), carried=carried)


def jax_flat_from_vqgan_state(state) -> dict[str, np.ndarray]:
    """The inverse of ``vqgan_state_from_jax_flat``."""
    flat = {}
    flat.update(_flat_from_params(state.g_params, "g_params/" + _PREFIX))
    flat.update(_flat_from_params(state.d_params, "d_params/" + _PREFIX))
    flat.update(_flat_from_params(state.ema["a2b"], "ema/a2b/" + _PREFIX))
    for opt, st in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        flat.update(_flat_from_params(st.mu, opt + _ADAM + "mu/" + _PREFIX))
        flat.update(_flat_from_params(st.nu, opt + _ADAM + "nu/" + _PREFIX))
        flat[opt + _ADAM + "count"] = np.int32(st.count)
        flat[opt + _SCHED] = np.int32(st.count)
    flat["step"] = np.int32(state.step)
    flat.update(state.carried)
    return flat
