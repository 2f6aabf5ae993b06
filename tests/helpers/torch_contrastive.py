"""Shared by the port's CUT, FastCUT, DCLGAN and antialias CycleGAN step
tests (``tests/test_torch_{cut,fastcut,cut_bf16,dclgan,antialias}_step.py``):
the JAX step's draws recomputed from its key, the port's state placed into
JAX's state structure, and the fp32 comparisons of
``test_torch_cyclegan_step.py`` (losses, gradients read from JAX's Adam
moments, moments, parameters, EMA and pools) over flat JAX keys.

A state is drawn by the port's ``init_state`` and carried into JAX through
``jax.eval_shape`` of JAX's init (a trace, no compile): JAX's eager init
costs a compile per op.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization, traverse_util

from uig.train.cut import sample_patch_ids
from uig_torch.convert import (_flat_from_nested, jax_flat_from_train_state,
                               train_state_from_jax_flat)

B1 = 0.5
RTOL_LOSS = 1e-5
REL_GRAD = 1e-5
ATOL = 1e-5
JAX_OPTIONS = {"xla_backend_optimization_level": 0}


def flat(state) -> dict:
    """A JAX state as flat numpy arrays, bf16 leaves widened (exact)."""
    out = {}
    for k, v in traverse_util.flatten_dict(
            serialization.to_state_dict(state), sep="/").items():
        a = np.asarray(v)
        out[k] = a.astype(np.float32) if a.dtype.name == "bfloat16" else \
            np.array(a)
    return out


def jax_state_from_port(jtr, port_state, key):
    """The port's state as JAX's state on ``jtr``'s mesh, with key ``key``."""
    abstract = jax.eval_shape(jtr._abstract_state, key)
    fl = jax_flat_from_train_state(port_state)
    fl["rng"] = np.asarray(key)
    fl["ada_p"] = np.float32(jtr.cfg.loss.ada_p_init)
    tree = serialization.from_state_dict(
        abstract, traverse_util.unflatten_dict(fl, sep="/"))
    tree = jax.tree_util.tree_map(lambda a, v: np.asarray(v, a.dtype),
                                  abstract, tree)
    return jax.device_put(tree, jtr.state_shardings())


def port_state(fl: dict, state_cls, pool_dtype=torch.float32):
    return train_state_from_jax_flat(fl, state_cls, seed=0,
                                     pool_dtype=pool_dtype)


def _step_key(rng, step):
    key = jax.random.fold_in(rng, jnp.asarray(step, jnp.uint32))
    return jax.random.fold_in(key, 0)  # axis index on make_mesh(1)


def _aug(key, batch: int, load: int, crop: int) -> tuple:
    k_off, k_flip = jax.random.split(key)
    oy = jax.random.randint(k_off, (batch,), 0, load - crop + 1)
    ox = jax.random.randint(jax.random.fold_in(k_off, 1), (batch,), 0,
                            load - crop + 1)
    return oy, ox, jax.random.bernoulli(k_flip, 0.5, (batch,))


def _pool(key, batch: int, count) -> tuple:
    k_idx, k_use = jax.random.split(key)
    idx = jax.random.randint(k_idx, (batch,), 0, jnp.maximum(count, 1))
    return idx, jax.random.bernoulli(k_use, 0.5, (batch,))


def _ids(key, shapes, batch: int, n: int) -> list:
    return [sample_patch_ids(jax.random.fold_in(key, i), batch, h * w,
                             min(n, h * w))
            for i, (h, w, _) in enumerate(shapes)]


@functools.partial(jax.jit, static_argnames=("names", "batch", "load",
                                             "crop", "shapes", "n"))
def _draw_arrays(rng, step, counts, *, names, batch, load, crop, shapes, n):
    """Every draw of a JAX step in one program: ``names`` are the step's
    key names in ``split_named`` order; ``counts`` the pools' fills, in the
    order of the names that start with "pool"."""
    sk = _step_key(rng, step)
    keys = dict(zip(names, jax.random.split(sk, len(names))))
    pools = iter(counts)
    out = {}
    for name, key in keys.items():
        if name.startswith("aug"):
            out[name] = _aug(key, batch, load, crop)
        elif name.startswith("pool"):
            out[name] = _pool(key, batch, next(pools))
        else:
            out[name] = _ids(key, shapes, batch, n)
    out["flip"] = jax.random.bernoulli(jax.random.fold_in(sk, 0xF11))
    return out


def _draws(ptr, state, step: int, batch: int, load: int, names, pools):
    shapes = tuple(tuple(s) for s in getattr(ptr, "tap_shapes", ()))
    counts = jnp.asarray([int(getattr(state, p).count) for p in pools],
                         jnp.int32)
    kw = dict(names=names, batch=batch, load=load,
              crop=ptr.cfg.model.image_size, shapes=shapes,
              n=getattr(ptr, "n_patches", 0))
    args = (state.rng, jnp.asarray(step, jnp.int32), counts)
    arrays = _draw_arrays.lower(*args, **kw).compile(
        compiler_options=JAX_OPTIONS)(*args)
    out = {k: tuple(torch.from_numpy(np.array(a)) for a in v)
           if k.startswith(("aug", "pool")) else
           [torch.from_numpy(np.array(a)).long() for a in v]
           for k, v in arrays.items() if k != "flip"}
    if "pool" in out:  # CUT's one pool is pool_b
        out["pool_b"] = out.pop("pool")
    return out, bool(arrays["flip"])


def flip_coin(state, step: int) -> bool:
    """FastCUT's coin of the JAX step (``cut.py:289``)."""
    return bool(jax.random.bernoulli(jax.random.fold_in(
        _step_key(state.rng, step), 0xF11)))


def cut_draws(ptr, state, step: int, batch: int, load: int) -> dict:
    """The draws of JAX's CUT step (``cut.py:270-296``), for the port's
    trainer ``ptr`` (its tap shapes, patch count and loss flags)."""
    out, flip = _draws(ptr, state, step, batch, load,
                       ("pool", "aug_a", "aug_b", "nce", "nce_idt"),
                       ("pool_b",))
    if not ptr.cfg.loss.nce_include_identity:
        del out["nce_idt"]
    if ptr.cfg.loss.nce_flip_equivariance:
        out["flip"] = flip
    return out


def cyclegan_draws(ptr, state, step: int, batch: int, load: int) -> dict:
    """The draws of JAX's CycleGAN step (``cyclegan.py:197-199``)."""
    return _draws(ptr, state, step, batch, load,
                  ("pool_a", "pool_b", "aug_a", "aug_b"),
                  ("pool_a", "pool_b"))[0]


def dclgan_draws(ptr, state, step: int, batch: int, load: int) -> dict:
    """The draws of JAX's DCLGAN step (``dclgan_trainer.py:244-246``)."""
    return _draws(ptr, state, step, batch, load,
                  ("pool_a", "pool_b", "aug_a", "aug_b", "nce_a", "nce_b"),
                  ("pool_a", "pool_b"))[0]


# ------------------------------------------------------------- comparisons
def jax_grads(jflats: list, opt: str, step: int) -> dict:
    """{leaf key under <opt>/0/0/mu/: JAX gradient at ``step``}: mu_1 =
    g_1 / 2 with b1 = 0.5; g_k = 2 mu_k - mu_{k-1}."""
    pre = f"{opt}/0/0/mu/"
    mu = {k[len(pre):]: v for k, v in jflats[step].items()
          if k.startswith(pre)}
    if step == 0:
        return {k: v / (1.0 - B1) for k, v in mu.items()}
    prev = jflats[step - 1]
    return {k: (v - B1 * prev[pre + k]) / (1.0 - B1) for k, v in mu.items()}


def port_grads(tree: dict) -> dict:
    """A gradient tree of the port under the keys ``jax_grads`` gives."""
    return {k[2:]: v for k, v in _flat_from_nested(tree, "x").items()}


def scale(tree: dict) -> float:
    return max(float(np.abs(v).max()) for v in tree.values())


def leaf_close(got, want, atol: float, what: str) -> None:
    err = np.abs(np.asarray(got, np.float64) - want)
    if err.size:
        assert err.max() <= atol, \
            f"{what}: max|err| {err.max():.3g} > {atol:.3g}"


def check_metrics(jm: dict, pm: dict, what: str) -> None:
    assert set(pm) == set(jm), (sorted(pm), sorted(jm))
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=RTOL_LOSS, atol=1e-7,
                                   err_msg=f"{what} {k}")


def check_grads(want: dict, got: dict, what: str, rel=REL_GRAD) -> None:
    assert set(got) == set(want)
    atol = rel * scale(want)
    for k, g in want.items():
        leaf_close(got[k], g, atol, f"{what} grad {k}")


def check_moments(want: dict, got: dict, rel_g=REL_GRAD) -> None:
    """Moments within REL_GRAD (G's within ``rel_g``) of each network's
    largest; the counts equal."""
    for opt in ("g_opt", "d_opt"):
        rel = rel_g if opt == "g_opt" else REL_GRAD
        for moment in ("mu", "nu"):
            pre = f"{opt}/0/0/{moment}/"
            leaves = {k: v for k, v in want.items() if k.startswith(pre)}
            atol = rel * scale(leaves)
            for k, v in leaves.items():
                leaf_close(got[k], v, atol, k)
        for k in (f"{opt}/0/0/count", f"{opt}/0/1/count"):
            assert int(got[k]) == int(want[k]), k


def tiny_grad_masks(jflats: list, upto: int, rel_g=REL_GRAD) -> dict:
    """{param key: elements whose JAX gradient fell below the gradient atol
    at some step <= upto (G's tolerance ``rel_g``)}: Adam turns a
    rounding-level gradient into +-lr of either sign."""
    masks = {}
    for opt, tree in (("g_opt", "g_params"), ("d_opt", "d_params")):
        rel = rel_g if opt == "g_opt" else REL_GRAD
        for step in range(upto + 1):
            grads = jax_grads(jflats, opt, step)
            atol = rel * scale(grads)
            for k, g in grads.items():
                key = f"{tree}/{k}"
                masks[key] = masks.get(key, False) | (np.abs(g) < atol)
    return masks


def check_params_ema_pools(want: dict, got: dict, masks: dict) -> tuple:
    """Parameters (but the masked elements), EMA and pools within ATOL;
    the counts equal. Returns (elements excluded, elements compared)."""
    excluded = total = 0
    for k, v in want.items():
        if k.startswith(("g_params/", "d_params/")):
            keep = ~masks[k]
            excluded += int((~keep).sum())
            total += keep.size
            leaf_close(np.asarray(got[k])[keep], v[keep], ATOL, k)
        elif k.startswith(("ema/", "pool_")) and k.endswith(
                ("kernel", "bias", "scale", "buffer")):
            leaf_close(got[k], v, ATOL, k)
        elif k.endswith("count") or k == "step":
            assert int(got[k]) == int(v), k
    return excluded, total
