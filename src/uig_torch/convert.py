"""Carry module weights (generators, LPIPS's VGG), and whole CycleGAN,
VQGAN, CUT and DCLGAN train states, between the JAX package's layout and
the port; and draw weights in that layout from a seed by flax's
initializers.

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
# whole train states
# ---------------------------------------------------------------------------
# A JAX train state crosses as a flat dict of numpy arrays: flax's
# ``serialization.to_state_dict`` of the state, flattened with "/". A flax
# module's parameters sit under ``.../params/<path>`` (<path> is flax's
# module path, "layers_9/PadConv_0/kernel"; the port's parameter name is
# the same path with dots), the trees above them are dicts:
#   CycleGAN: g_params/{a2b,b2a}/params/<path>, d_params/{a,b}/params/<path>,
#             ema/{a2b,b2a}/params/<path>, pool_a/..., pool_b/...
#   VQGAN:    g_params/params/<path>, d_params/params/<path>,
#             ema/a2b/params/<path>
#   CUT:      g_params/gen/params/<path>, g_params/heads/<i>/params/<path>
#             (JAX's list of heads, keyed "0", "1", ...),
#             d_params/params/<path>, ema/a2b/params/<path>, pool_b/...
#   DCLGAN:   g_params/{a2b,b2a}/{gen,heads/<i>}/params/<path>,
#             d_params/{a,b}/params/<path>, ema/{a2b,b2a}/params/<path>,
#             pool_a/..., pool_b/...
# with {g,d}_opt/0/0/{count,mu/<tree>,nu/<tree>} (optax.chain(optax.adam):
# ScaleByAdamState) and {g,d}_opt/0/1/count (the schedule's count, equal to
# Adam's), pool_*/{buffer,count}, step, rng and, but for VQGAN, ada_p.

_STATE_TREES = ("g_params", "d_params", "ema")
_ADAM = "/0/0/"
_SCHED = "/0/1/count"


def _numpy(t: torch.Tensor) -> np.ndarray:
    """An fp32 numpy copy (never a view of a tensor a later step updates);
    exact for bf16 tensors."""
    return np.array(t.detach().to(torch.float32).cpu(), dtype=np.float32)


def _nested_from_flat(flat: dict, root: str, device) -> dict:
    out: dict = {}
    pre = root + "/"
    for key, value in flat.items():
        if not key.startswith(pre):
            continue
        rest = key[len(pre):]
        if rest.startswith(_PREFIX):
            tree, path = [], rest[len(_PREFIX):]
        elif "/" + _PREFIX in rest:
            head, path = rest.split("/" + _PREFIX, 1)
            tree = head.split("/")
        else:
            raise KeyError(f"{key!r}: expected {root}/.../{_PREFIX}...")
        node = out
        for name in tree:
            node = node.setdefault(name, {})
        node[path.replace("/", ".")] = torch.from_numpy(
            np.array(value, dtype=np.float32)).to(device)
    return out


def _flat_from_nested(tree: dict, root: str) -> dict:
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return {f"{root}/{_PREFIX}" + name.replace(".", "/"): _numpy(t)
                for name, t in tree.items()}
    out = {}
    for name, sub in tree.items():
        out.update(_flat_from_nested(sub, f"{root}/{name}"))
    return out


def train_state_from_jax_flat(flat: dict[str, np.ndarray], state_cls,
                              seed: int = 0, device="cpu",
                              pool_dtype=torch.float32):
    """A flat JAX train state -> the port's ``state_cls`` (``CycleGANState``,
    ``VQGANState``, ``CUTState``, ``DCLGANState``) on ``device``. ``seed``
    seeds the port's own per-step draws (the JAX key, and ``ada_p``, cannot
    be used and stay in ``carried`` unchanged). The replay pools hold the
    compute dtype, ``pool_dtype``; a bf16 pool crosses as fp32 arrays
    (exact), which the caller widens from JAX's bf16."""
    import dataclasses

    from uig_torch.train.pool import PoolState
    from uig_torch.train.state import AdamState

    def adam(opt: str) -> AdamState:
        count = int(flat[opt + _ADAM + "count"])
        sched = int(flat[opt + _SCHED])
        if sched != count:
            raise ValueError(f"{opt}: schedule count {sched} != Adam count "
                             f"{count}")
        return AdamState(
            count, _nested_from_flat(flat, opt + _ADAM + "mu", device),
            _nested_from_flat(flat, opt + _ADAM + "nu", device))

    kw = {k: _nested_from_flat(flat, k, device) for k in _STATE_TREES}
    kw.update(g_opt=adam("g_opt"), d_opt=adam("d_opt"),
              step=int(flat["step"]), seed=int(seed),
              carried={k: np.asarray(flat[k]) for k in ("rng", "ada_p")
                       if k in flat})
    for f in dataclasses.fields(state_cls):
        if f.name.startswith("pool_"):
            kw[f.name] = PoolState(torch.from_numpy(np.array(
                flat[f.name + "/buffer"], dtype=np.float32)).to(
                    device, pool_dtype), int(flat[f.name + "/count"]))
    return state_cls(**kw)


def jax_flat_from_train_state(state) -> dict[str, np.ndarray]:
    """The inverse of ``train_state_from_jax_flat``, for any of the port's
    train states: numpy arrays under the JAX state's flat keys (counts and
    step as int32)."""
    import dataclasses

    flat = {}
    for k in _STATE_TREES:
        flat.update(_flat_from_nested(getattr(state, k), k))
    for opt in ("g_opt", "d_opt"):
        st = getattr(state, opt)
        flat.update(_flat_from_nested(st.mu, opt + _ADAM + "mu"))
        flat.update(_flat_from_nested(st.nu, opt + _ADAM + "nu"))
        flat[opt + _ADAM + "count"] = np.int32(st.count)
        flat[opt + _SCHED] = np.int32(st.count)
    for f in dataclasses.fields(state):
        if f.name.startswith("pool_"):
            p = getattr(state, f.name)
            flat[f.name + "/buffer"] = _numpy(p.buffer)
            flat[f.name + "/count"] = np.int32(p.count)
    flat["step"] = np.int32(state.step)
    flat.update(state.carried)
    return flat


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------


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
