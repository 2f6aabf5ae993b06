"""Train state, learning-rate schedule and Adam: the port of the JAX
package's ``train/state.py``.

``Adam`` has optax's semantics (``optax.adam`` under ``optax.chain``): the
moments update as (1 - b) * g + b * m, bias correction uses the incremented
count, eps sits outside the square root, and the learning rate is the
schedule at the count *before* it increments. It updates parameters and
moments in place, with multi-tensor (``_foreach``) ops in a fixed order.
Gradient clipping, weight decay and SGD are not ported yet and raise.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from uig_torch.train.pool import PoolState


def lr_schedule(opt, lr_scale: float = 1.0):
    """``step -> lr`` for ``opt.lr_decay`` in linear | cosine | constant,
    optionally composed with a linear warmup over ``opt.warmup_steps``;
    evaluated in fp32, as the JAX schedule is."""
    decay_steps = max(opt.total_steps - opt.decay_start_step, 1)
    kind = opt.lr_decay
    if kind not in ("linear", "cosine", "constant"):
        raise ValueError(
            f"opt.lr_decay must be linear|cosine|constant, got {kind!r}")
    if opt.warmup_steps < 0:
        raise ValueError(f"opt.warmup_steps must be >= 0, got {opt.warmup_steps}")
    f32 = np.float32

    def schedule(step) -> float:
        s = f32(step)
        frac = np.clip((s - f32(opt.decay_start_step)) / f32(decay_steps),
                       f32(0.0), f32(1.0))
        if kind == "linear":
            decay = f32(1.0) - frac
        elif kind == "cosine":
            decay = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * frac))
        else:
            decay = f32(1.0)
        lr = f32(opt.lr * lr_scale) * decay
        if opt.warmup_steps > 0:
            lr = lr * np.clip((s + f32(1.0)) / f32(opt.warmup_steps),
                              f32(0.0), f32(1.0))
        return float(lr)

    return schedule


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_unflatten(like: dict, leaves) -> dict:
    """The inverse of ``tree_leaves``: ``leaves`` in ``like``'s structure."""
    it = iter(leaves)

    def walk(tree):
        return {k: walk(tree[k]) if isinstance(tree[k], dict) else next(it)
                for k in sorted(tree)}

    return walk(like)


def normal_init(module: torch.nn.Module, gen: torch.Generator) -> dict:
    """The ResNet generator's and the PatchGAN's flax initializers: conv
    kernels normal(0.02), biases zeros, instance-norm scales ones."""
    params = {}
    for name, p in module.named_parameters():
        if name.endswith(".kernel"):
            v = torch.randn(p.shape, generator=gen) * 0.02
        elif name.endswith(".scale"):
            v = torch.ones(p.shape)
        else:
            v = torch.zeros(p.shape)
        params[name] = v
    return params


@dataclass
class AdamState:
    count: int
    mu: dict
    nu: dict


class Adam:
    def __init__(self, opt, lr_scale: float = 1.0):
        if opt.optimizer != "adam":
            raise NotImplementedError(
                f"opt.optimizer={opt.optimizer!r}: the port has adam only "
                "(sgd is on the ROADMAP)")
        if opt.grad_clip > 0:
            raise NotImplementedError(
                "opt.grad_clip > 0: global-norm clipping is not ported yet "
                "(ROADMAP)")
        if opt.weight_decay > 0:
            raise NotImplementedError(
                "opt.weight_decay > 0: adamw is not ported yet (ROADMAP)")
        self.b1, self.b2, self.eps = opt.b1, opt.b2, opt.eps
        self.lr = lr_schedule(opt, lr_scale)

    def init(self, params: dict) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, params: dict, grads: list[torch.Tensor],
               state: AdamState) -> AdamState:
        """Apply one step in place. ``grads`` follow ``tree_leaves(params)``."""
        ps, mu, nu = tree_leaves(params), tree_leaves(state.mu), tree_leaves(state.nu)
        b1, b2 = self.b1, self.b2
        neg_lr = -self.lr(state.count)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(b1) ** count)
        bc2 = float(f32(1.0) - f32(b2) ** count)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(ps, upd)
        state.count = count
        return state


class _TrainState:
    """``clone`` and ``to``, shared by the train states: dataclasses of
    parameter trees, Adam states, replay pools and integers."""

    def clone(self):
        """A deep copy (``train_step`` consumes the state it is given)."""
        return copy.deepcopy(self)

    def to(self, device):
        """A deep copy with every tensor on ``device``."""
        def move(value):
            if isinstance(value, dict):
                return tree_map(lambda t: t.to(device, copy=True), value)
            if isinstance(value, AdamState):
                return AdamState(value.count, move(value.mu), move(value.nu))
            if isinstance(value, PoolState):
                return PoolState(value.buffer.to(device, copy=True),
                                 value.count)
            return copy.copy(value)

        return type(self)(**{f.name: move(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


@dataclass
class CycleGANState(_TrainState):
    """Two generators, two discriminators, their Adam states, the EMA of the
    generators, two replay pools and the step. Parameter trees are dicts of
    fp32 tensors keyed as the modules' state dicts: ``g_params`` and
    ``ema`` under ``"a2b"``/``"b2a"``, ``d_params`` under ``"a"``/``"b"``.
    ``carried`` keeps JAX state fields the port does not use (the PRNG key,
    ``ada_p``) so that a state converted from JAX converts back whole."""
    g_params: dict
    d_params: dict
    g_opt: AdamState
    d_opt: AdamState
    ema: dict
    pool_a: PoolState
    pool_b: PoolState
    step: int
    seed: int
    carried: dict = field(default_factory=dict)


@dataclass
class VQGANState(_TrainState):
    """The VQGAN trainer's state: one generator (the shared autoencoder) and
    one discriminator, their Adam states, the EMA of the generator under
    ``"a2b"`` (translate is reconstruct), and the step. Parameter trees are
    flat dicts of fp32 tensors keyed as the modules' state dicts.
    ``carried`` keeps JAX state fields the port does not use (the PRNG
    key)."""
    g_params: dict
    d_params: dict
    g_opt: AdamState
    d_opt: AdamState
    ema: dict
    step: int
    seed: int
    carried: dict = field(default_factory=dict)


@dataclass
class CUTState(_TrainState):
    """The CUT (and FastCUT) trainer's state: ``g_params`` holds the
    generator under ``"gen"`` and the projection heads under ``"heads"``
    (one flat dict a tap, keyed ``"0"``, ``"1"``, ... in tap order), one Adam
    state over both; one discriminator; the EMA of the generator under
    ``"a2b"``; one replay pool of fake B images; the step. ``carried``
    keeps JAX state fields the port does not use (the PRNG key,
    ``ada_p``)."""
    g_params: dict
    d_params: dict
    g_opt: AdamState
    d_opt: AdamState
    ema: dict
    pool_b: PoolState
    step: int
    seed: int
    carried: dict = field(default_factory=dict)


@dataclass
class DCLGANState(CycleGANState):
    """The DCLGAN trainer's state, in ``CycleGANState``'s fields:
    ``g_params`` under ``"a2b"`` and ``"b2a"`` are each ``{"gen":
    generator, "heads": {"0": head, ...}}`` (each direction owns its
    generator and the heads over its encoder's taps), one Adam state over
    both; the rest as CycleGAN's."""
