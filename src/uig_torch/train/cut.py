"""CUT and FastCUT trainer, in PyTorch: the port of the JAX package's
``train/cut.py`` ``CUTTrainer`` for one device.

One generator (a2b) and one discriminator; PatchNCE in place of the cycle
loss. Encoder features of the input and of its translation are compared at
matched spatial ids (positives) against the other ids of the same image
(negatives), each tap through its own two-layer projection head, trained
with the generator under one Adam. One ``train_step`` computes what JAX's
``_device_step`` computes:

1. augment both uint8 batches on the device (the augment kernel); with
   ``loss.nce_flip_equivariance`` (FastCUT) mirror the whole batch on a
   coin, and mirror the query features back along W before matching;
2. the G loss: adversarial + lambda_nce * NCE(real_a, fake_b), and with
   ``loss.nce_include_identity`` + lambda_nce * NCE(real_b, G(real_b)); its
   gradient for the generator and the heads;
3. the replay pool's ``query``;
4. the D loss on [real_b, pooled fake_b] and its gradient;
5. Adam on {generator, heads} at the schedule's LR, the EMA of the
   generator, Adam on D at ``opt.d_lr_ratio``.

The keys of an NCE term are the features of the real image, read from the
full apply that makes its translation (``ResNetGenerator.with_features``):
the function JAX computes with a separate encoder apply that XLA merges
with the full one. The queries come from an encoder-only apply of the
translation (``encode_features``), which stops at the last tap. With
``model.fused_applies`` the translation and identity applies run as one
apply at 2B, and so do the two encoder passes.

The draws (crop offsets, flips, the pool's slots and coins, FastCUT's
coin, each tap's patch ids) come from the (seed, step) generator or are
passed in; the patch ids are a uniform n-subset of each image's spatial
ids without replacement (the top n of uniform scores, as JAX draws them),
drawn on the trainer's device from a seed the step generator gives.

Precision as in ``train/cyclegan.py``: the compute dtype's casts, fp32
parameters, moments, EMA, losses and NCE; the heads' Dense layers compute
in the compute dtype with fp32 parameters, as flax's ``nn.Dense(dtype=)``.
Refused with NotImplementedError: ADA and R1, ``opt.grad_accum > 1``
(ROADMAP §1 item 7), ``model.remat`` other than none (item 6).
``translate`` runs the EMA generator in ``model.eval_dtype``, a2b only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from uig_torch.config.config import remat_mode
from uig_torch.kernels.augment import draw_augment
from uig_torch.models import (PatchDiscriminator, generator_from_config,
                              model_dtype)
from uig_torch.runtime import resolve_device
from uig_torch.runtime.prng import step_generator
from uig_torch.serving import exact_for, exact_fp32
from uig_torch.train import losses as L
from uig_torch.train.cyclegan import CycleGANTrainer
from uig_torch.train.ema import ema_update
from uig_torch.train.pool import ImagePool
from uig_torch.train.state import (Adam, CUTState, normal_init, tree_leaves,
                                   tree_map, tree_unflatten)


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=dtype, param_dtype=float32)``: the
    input and the kernel cast to ``dtype``, a matmul in it, the bias cast
    to it and added after it."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class ProjectionHead(nn.Module):
    """A tap's two-layer MLP, C -> dim -> dim with a ReLU between (the unit
    norm is the loss's). Parameters keep flax's names (``Dense_0``,
    ``Dense_1``)."""

    def __init__(self, in_features: int, dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_features, dim, dtype)
        self.Dense_1 = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def lecun_normal_init(module: nn.Module, gen: torch.Generator) -> dict:
    """flax's Dense initializers, drawn from ``gen``: each kernel
    lecun-normal (a normal truncated at 2 sigma, scaled to variance
    1 / fan_in), each bias zeros."""
    params = {}
    for name, p in module.named_parameters():
        if name.endswith(".kernel"):
            v = torch.randn(p.shape, generator=gen)
            while (bad := v.abs() > 2.0).any():
                v[bad] = torch.randn(int(bad.sum()), generator=gen)
            v *= math.sqrt(1.0 / p.shape[0]) / 0.87962566103423978
        else:
            v = torch.zeros(p.shape)
        params[name] = v
    return params


def sample_patches(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C), idx (B, N) flat spatial ids -> (B, N, C)."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    return torch.gather(flat, 1, idx.to(feat.device)[..., None].expand(
        -1, -1, c))


def draw_patch_ids(seed: int, shapes, batch: int, n_patches: int,
                   device) -> list[torch.Tensor]:
    """For each tap's (H, W, C) in ``shapes``: (batch, min(n_patches, H W))
    spatial ids, a uniform subset without replacement per image (the top n
    of uniform scores), drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    ids = []
    for h, w, _ in shapes:
        n = min(n_patches, h * w)
        scores = torch.rand((batch, h * w), generator=gen, device=device)
        ids.append(torch.topk(scores, n, dim=1).indices)
    return ids


def check_taps(layers, n_layers: int) -> tuple:
    """``model.nce_layers`` as JAX's trainers take it: every tap in range,
    else ValueError."""
    taps = tuple(i for i in layers if i < n_layers)
    if not taps:
        raise ValueError(
            f"model.nce_layers={layers} are all out of range for this "
            f"generator (valid feature-tap indices: 0..{n_layers - 1})")
    if len(taps) != len(layers):
        dropped = tuple(i for i in layers if i >= n_layers)
        raise ValueError(
            f"model.nce_layers contains out-of-range taps {dropped}; valid "
            f"feature-tap indices for this generator: 0..{n_layers - 1}")
    return taps


def refuse_unported(cfg, trainer: str) -> None:
    """NotImplementedError, naming its ROADMAP item, for every field of the
    contrastive trainers that the port does not honour."""
    loss, opt = cfg.loss, cfg.opt
    unported = {
        "loss.r1_gamma > 0 (ROADMAP §1 item 7: R1 needs a double backward "
        "through the norm kernels)": loss.r1_gamma > 0,
        "ADA, loss.ada_target / loss.ada_p_init > 0 (ROADMAP §1 item 7)":
            loss.ada_target > 0 or loss.ada_p_init > 0,
        "opt.grad_accum > 1 (ROADMAP §1 item 7)": opt.grad_accum > 1,
        f"model.remat={cfg.model.remat!r} (ROADMAP §1 item 6: "
        "rematerialization)": remat_mode(cfg.model.remat) != "none",
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{trainer}: {what} is not ported yet; "
                                      "set it off")
    if cfg.data.augment not in ("pallas", "xla", "none"):
        raise ValueError(f"unknown augment impl {cfg.data.augment!r}")


class ContrastiveBase:
    """What the CUT and DCLGAN trainers share: the generator (in the
    compute and the eval dtype), the discriminator, one projection head a
    tap, both Adams, the pool, the input, the NCE term and ``train_step``
    (``_grads``, then ``_update``, as ``CycleGANTrainer``'s)."""

    _input = CycleGANTrainer._input
    _with_grad = staticmethod(CycleGANTrainer._with_grad)

    def _build(self, cfg, device) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        m = cfg.model
        self.dtype = model_dtype(m, "compute_dtype")
        self._precision = exact_for(self.dtype)
        self.generator = generator_from_config(
            m, "compute_dtype").to(self.device)
        eval_dtype = model_dtype(m, "eval_dtype")
        self.eval_generator = (
            self.generator if eval_dtype == self.dtype
            else generator_from_config(m, "eval_dtype").to(self.device))
        self._eval_precision = exact_for(eval_dtype)
        self.discriminator = PatchDiscriminator(
            base_features=m.d_base_features, n_layers=m.d_layers, norm=m.norm,
            in_channels=m.out_channels, dtype=self.dtype).to(self.device)
        self.taps = check_taps(m.nce_layers, self.generator.num_layers)
        self.n_patches = m.nce_patches
        hw = m.image_size
        self.tap_shapes = self.generator.feature_shapes(
            self.taps, hw, hw, m.in_channels)
        self.heads = [ProjectionHead(c, m.nce_proj_dim, self.dtype).to(
            self.device) for _, _, c in self.tap_shapes]
        for mod in (self.generator, self.eval_generator, self.discriminator,
                    *self.heads):
            mod.requires_grad_(False)
        self._with_features = _Method(self.generator, "with_features")
        self._encode = _Method(self.generator, "encode_features")
        self.g_tx = Adam(cfg.opt)
        self.d_tx = Adam(cfg.opt, lr_scale=cfg.opt.d_lr_ratio)
        self.pool = ImagePool(cfg.opt.pool_size)

    def _branch_init(self, gen: torch.Generator) -> dict:
        return {"gen": normal_init(self.generator, gen),
                "heads": {str(i): lecun_normal_init(h, gen)
                          for i, h in enumerate(self.heads)}}

    def _on_dev(self, tree: dict) -> dict:
        return tree_map(lambda t: t.to(self.device), tree)

    def _patch_ids(self, gen: torch.Generator, batch: int) -> list:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        return draw_patch_ids(seed, self.tap_shapes, batch, self.n_patches,
                              self.device)

    def _G(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.generator, params, (x,))

    def _G_features(self, params: dict, x: torch.Tensor):
        """(G(x), its features at the taps) with ``params``."""
        return _method_call(self._with_features, params, x, self.taps)

    def _G_encode(self, params: dict, x: torch.Tensor) -> list:
        """The features of x at the taps, the encoder only, with
        ``params``."""
        return _method_call(self._encode, params, x, self.taps)

    def _D(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.discriminator, params, (x,))

    def _nce(self, heads_k: dict, heads_q: dict, f_k: list, f_q: list,
             ids: list, flip: bool = False) -> torch.Tensor:
        """The mean over taps of PatchNCE between the keys ``f_k`` through
        ``heads_k`` and the queries ``f_q`` through ``heads_q``, at each
        tap's patch ids; with ``flip`` the queries are mirrored back along
        W first (FastCUT)."""
        temp = self.cfg.loss.nce_temperature
        total = 0.0
        for i, (fk, fq, idx) in enumerate(zip(f_k, f_q, ids)):
            if flip:
                fq = torch.flip(fq, (2,))
            head = self.heads[i]
            q = functional_call(head, heads_q[str(i)],
                                (sample_patches(fq, idx),))
            k = functional_call(head, heads_k[str(i)],
                                (sample_patches(fk, idx),))
            total = total + L.patch_nce_loss(q, k, temp)
        return total / len(self.taps)

    def train_step(self, state, batch, draws: dict | None = None):
        """One step on ``batch = (a, b)`` (uint8 batches augmented on the
        device, or floats in [-1, 1] taken as they are); ``draws`` as
        ``draw`` returns them (drawn when None). Updates ``state`` in place
        and returns ``(state, metrics)``, 0-dim fp32 tensors under JAX's
        names."""
        if draws is None:
            shape = np.shape(batch[0])
            draws = self.draw(state, shape[0], shape[1], shape[2])
        grads, metrics = self._grads(state, batch, draws)
        self._update(state, grads)
        return state, metrics

    def _translate(self, ema: dict, x: torch.Tensor,
                   direction: str) -> torch.Tensor:
        with torch.inference_mode(), self._eval_precision():
            return functional_call(self.eval_generator, ema[direction],
                                   (x.to(self.device, torch.float32),))


class _Method(nn.Module):
    """A module whose ``forward`` is another method of ``m``, so that
    ``functional_call`` (which calls ``forward`` only) can run it."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.m, self.method = module, method

    def forward(self, x, taps):
        return getattr(self.m, self.method)(x, taps)


def _method_call(wrapper: _Method, params: dict, x: torch.Tensor, taps):
    """``wrapper.m.<method>(x, taps)`` with ``params`` in place of the
    parameters of ``wrapper.m``."""
    return functional_call(wrapper, {f"m.{k}": v for k, v in params.items()},
                           (x, taps))


class CUTTrainer(ContrastiveBase):
    """One generator (a2b, with a projection head a tap) and one
    discriminator.

      init_state(seed)                    -> CUTState
      train_step(state, (a, b), draws)    -> (state, metrics)
      translate(ema, x, "a2b")            -> translated images
    """

    directions = ("a2b",)

    def __init__(self, cfg, device: str = "cuda"):
        refuse_unported(cfg, "CUTTrainer")
        self._build(cfg, device)

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int) -> CUTState:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        g_params = self._on_dev(self._branch_init(gen))
        d_params = self._on_dev(normal_init(self.discriminator, gen))
        hw = self.cfg.model.image_size
        img = (hw, hw, self.cfg.model.out_channels)
        return CUTState(
            g_params=g_params, d_params=d_params,
            g_opt=self.g_tx.init(g_params), d_opt=self.d_tx.init(d_params),
            ema={"a2b": tree_map(torch.clone, g_params["gen"])},
            pool_b=self.pool.init(img, self.device, self.dtype),
            step=0, seed=int(seed))

    # ----------------------------------------------------------------- draws
    def draw(self, state: CUTState, batch: int, height: int,
             width: int) -> dict:
        """The step's draws from the (seed, step) generator: crop offsets
        and flips for each batch, the pool's slots and coins, FastCUT's
        coin (``flip``, a bool), and each tap's patch ids for the NCE terms
        (``nce``, ``nce_idt``; drawn on the trainer's device)."""
        gen = step_generator(state.seed, state.step)
        crop = self.cfg.model.image_size
        loss = self.cfg.loss
        out = {"aug_a": draw_augment(gen, batch, height, width, crop),
               "aug_b": draw_augment(gen, batch, height, width, crop),
               "pool_b": self.pool.draw(gen, state.pool_b, batch)}
        if loss.nce_flip_equivariance:
            out["flip"] = bool(torch.rand((), generator=gen) < 0.5)
        out["nce"] = self._patch_ids(gen, batch)
        if loss.nce_include_identity:
            out["nce_idt"] = self._patch_ids(gen, batch)
        return out

    # ------------------------------------------------------------------ step
    def _g_loss(self, gp: dict, dp: dict, real_a, real_b, draws: dict):
        loss = self.cfg.loss
        flip = bool(draws.get("flip", False))
        heads = gp["heads"]
        zero = torch.zeros((), device=self.device)
        if self.cfg.model.fused_applies and loss.nce_include_identity:
            # the translation and identity applies as one at 2B, then both
            # encoder passes at 2B: instance norm is per example
            out, f_real = self._G_features(gp["gen"],
                                           torch.cat([real_a, real_b], 0))
            fake_b, idt_b = torch.chunk(out, 2, 0)
            f_fake = self._G_encode(gp["gen"], torch.cat([fake_b, idt_b], 0))
            f_ra, f_rb = zip(*(torch.chunk(f, 2, 0) for f in f_real))
            f_fb, f_ib = zip(*(torch.chunk(f, 2, 0) for f in f_fake))
            nce = self._nce(heads, heads, f_ra, f_fb, draws["nce"], flip)
            nce_idt = self._nce(heads, heads, f_rb, f_ib, draws["nce_idt"],
                                flip)
        else:
            fake_b, f_ra = self._G_features(gp["gen"], real_a)
            f_fb = self._G_encode(gp["gen"], fake_b)
            nce = self._nce(heads, heads, f_ra, f_fb, draws["nce"], flip)
            nce_idt = zero
            if loss.nce_include_identity:
                idt_b, f_rb = self._G_features(gp["gen"], real_b)
                f_ib = self._G_encode(gp["gen"], idt_b)
                nce_idt = self._nce(heads, heads, f_rb, f_ib,
                                    draws["nce_idt"], flip)
        adv = L.gan_loss_g(self._D(dp, fake_b), loss.gan_mode)
        total = adv + loss.lambda_nce * nce
        if loss.nce_include_identity:
            total = total + loss.lambda_nce * nce_idt
        return total, {"fake_b": fake_b, "g_adv": adv, "nce": nce,
                       "nce_idt": nce_idt}

    def _grads(self, state: CUTState, batch, draws: dict):
        """The step's gradients at ``state``'s parameters (``"g"``: the
        generator and the heads, ``"d"``) and its metrics; queries the
        replay pool, whose new state it writes into ``state``."""
        a_in, b_in = batch
        mode = self.cfg.loss.gan_mode
        with self._precision():
            real_a = self._input(a_in, draws["aug_a"])
            real_b = self._input(b_in, draws["aug_b"])
            if draws.get("flip", False):  # FastCUT: the whole batch
                real_a, real_b = (torch.flip(x, (2,)) for x in
                                  (real_a, real_b))

            gp = self._with_grad(state.g_params)
            g_loss, aux = self._g_loss(gp, state.d_params, real_a, real_b,
                                       draws)
            g_grads = torch.autograd.grad(g_loss, tree_leaves(gp))

            state.pool_b, d_fake_b = self.pool.query(
                state.pool_b, aux.pop("fake_b").detach(), *draws["pool_b"])
            del gp

            dp = self._with_grad(state.d_params)
            if self.cfg.model.fused_applies:
                rb, fb = torch.chunk(
                    self._D(dp, torch.cat([real_b, d_fake_b], 0)), 2, 0)
            else:
                rb, fb = self._D(dp, real_b), self._D(dp, d_fake_b)
            d_loss = L.gan_loss_d(rb, fb, mode)
            d_grads = torch.autograd.grad(d_loss, tree_leaves(dp))
        grads = {"g": tree_unflatten(state.g_params, g_grads),
                 "d": tree_unflatten(state.d_params, d_grads)}
        metrics = {
            "g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
            "g_adv": aux["g_adv"].detach(), "nce": aux["nce"].detach(),
            "nce_idt": aux["nce_idt"].detach(),
            "lr": torch.tensor(self.g_tx.lr(state.step), dtype=torch.float32,
                               device=self.device),
        }
        return grads, metrics

    def _update(self, state: CUTState, grads: dict) -> None:
        """Adam on the generator and heads, the EMA of the generator, Adam
        on the discriminator; then the step count."""
        with exact_fp32():
            self.g_tx.update(state.g_params, tree_leaves(grads["g"]),
                             state.g_opt)
            ema_update(state.ema, {"a2b": state.g_params["gen"]},
                       self.cfg.opt.ema_decay)
            self.d_tx.update(state.d_params, tree_leaves(grads["d"]),
                             state.d_opt)
        state.step += 1

    # ------------------------------------------------------------- translate
    def translate(self, ema: dict, x: torch.Tensor,
                  direction: str = "a2b") -> torch.Tensor:
        """[-1, 1] NHWC images -> the EMA generator's translation in
        ``model.eval_dtype``, no gradient. CUT translates a2b only, and
        raises JAX's ValueError for any other direction."""
        if direction != "a2b":
            raise ValueError("CUT is single-direction (a2b)")
        return self._translate(ema, x, direction)
