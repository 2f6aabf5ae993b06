"""CycleGAN trainer, in PyTorch: the port of the JAX package's
``train/cyclegan.py`` ``CycleGANTrainer`` for one device.

One ``train_step`` computes what ``_device_step`` computes:

1. augment both uint8 batches on the device (the augment kernel);
2. the generator loss: the fake and identity passes of each generator as
   one apply at 2B when ``model.fused_applies``, then the reconstructions;
   LSGAN (or the configured mode) adversarial + lambda * L1 cycle +
   lambda_id * lambda * L1 identity + lambda_lpips * (LPIPS(real_a, rec_a)
   + LPIPS(real_b, rec_b)); its gradient for the generators' parameters
   only;
3. both replay pools' ``query``;
4. the discriminator loss on 2B applies of [real, pooled fake] and its
   gradient;
5. Adam on the generators at the schedule's LR for the count before it
   increments, the EMA, and Adam on the discriminators at
   ``opt.d_lr_ratio``.

The D loss reads the fakes of step 2, not the updated generators, so taking
every gradient before any update gives JAX's result (``_grads``, then
``_update``).

The modules hold no trained state: parameters live in a ``CycleGANState``
of tensors and are applied with ``torch.func.functional_call``. A step
consumes its state and updates it in place (JAX donates it); clone a state
to keep it. The per-step draws (crop offsets, flips, pool slots and coins)
come from a generator seeded by (seed, step), or are passed in.

``model.compute_dtype`` is float32 or bfloat16 (every preset's default).
In bf16 the models compute with JAX's explicit casts (``models/layers.py``):
the augmented batches, activations and replay pools are bf16; parameters,
their gradients, Adam, the EMA, instance-norm statistics and the losses are
fp32. On the card the step runs without TF32 and with deterministic cuDNN
algorithms (``serving.exact_fp32``; in bf16 ``serving.exact_bf16``, which
also keeps cuBLAS's bf16 reductions in fp32); the CUDA kernels sum in a
fixed order, so a step repeats bit for bit.

With ``loss.lambda_lpips > 0`` the trainer builds LPIPS from its config,
as the JAX package's ``build_trainer`` does (``eval/lpips.py``: the VGG from
``eval.vgg_weights`` or drawn from seed 0, which needs no file); a caller
may pass its own ``perceptual_fn`` instead. LPIPS runs in fp32 whatever the
compute dtype, as in JAX, and is not part of the train state. Not ported
yet, and refused: R1, ADA, gradient accumulation, gradient clipping, weight
decay and SGD. ``translate`` runs the EMA generator in ``model.eval_dtype``,
float32 or bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from uig_torch.eval.lpips import trainer_lpips
from uig_torch.kernels.augment import (augment_batch, center_crop_normalize,
                                       draw_augment)
from uig_torch.models import (PatchDiscriminator, generator_from_config,
                              model_dtype)
from uig_torch.runtime import resolve_device
from uig_torch.runtime.prng import step_generator
from uig_torch.serving import exact_for, exact_fp32
from uig_torch.train import losses as L
from uig_torch.train.ema import ema_update
from uig_torch.train.pool import ImagePool
from uig_torch.train.state import (Adam, CycleGANState, normal_init,
                                   tree_leaves, tree_map, tree_unflatten)


def _refuse_unported(cfg) -> None:
    loss, opt = cfg.loss, cfg.opt
    unported = {
        "loss.r1_gamma > 0 (R1 needs a double backward through the norm "
        "kernels)": loss.r1_gamma > 0,
        "ADA (loss.ada_target / loss.ada_p_init > 0)":
            loss.ada_target > 0 or loss.ada_p_init > 0,
        "opt.grad_accum > 1": opt.grad_accum > 1,
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"CycleGANTrainer: {what} is not ported "
                                      "yet (ROADMAP); set it off")
    if cfg.data.augment not in ("pallas", "xla", "none"):
        raise ValueError(f"unknown augment impl {cfg.data.augment!r}")


class CycleGANTrainer:
    """Two generators (a2b, b2a) and two discriminators (a, b) with
    alternating Adam updates.

      init_state(seed)                    -> CycleGANState
      train_step(state, (a, b), draws)    -> (state, metrics)
      translate(ema, x, direction)        -> translated images

    ``perceptual_fn(x, y)`` -> 0-dim fp32, the LPIPS term's distance; by
    default ``make_lpips`` of the config when ``loss.lambda_lpips > 0``.
    """

    def __init__(self, cfg, device: str = "cuda", perceptual_fn=None):
        self.device = resolve_device(device)
        _refuse_unported(cfg)
        self.cfg = cfg
        self.perceptual_fn = (trainer_lpips(cfg, self.device)
                              if perceptual_fn is None else perceptual_fn)
        m = cfg.model
        self.dtype = model_dtype(m, "compute_dtype")
        self._precision = exact_for(self.dtype)
        self.generator = generator_from_config(
            m, "compute_dtype").to(self.device)
        # translate's generator, in model.eval_dtype (the same parameters)
        eval_dtype = model_dtype(m, "eval_dtype")
        self.eval_generator = (
            self.generator if eval_dtype == self.dtype
            else generator_from_config(m, "eval_dtype").to(self.device))
        self._eval_precision = exact_for(eval_dtype)
        self.discriminator = PatchDiscriminator(
            base_features=m.d_base_features, n_layers=m.d_layers, norm=m.norm,
            in_channels=m.out_channels, dtype=self.dtype).to(self.device)
        for mod in (self.generator, self.eval_generator, self.discriminator):
            mod.requires_grad_(False)
        self.g_tx = Adam(cfg.opt)
        self.d_tx = Adam(cfg.opt, lr_scale=cfg.opt.d_lr_ratio)
        self.pool = ImagePool(cfg.opt.pool_size)

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int) -> CycleGANState:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        dev = self.device

        def on_dev(tree):
            return tree_map(lambda t: t.to(dev), tree)

        g_params = on_dev({"a2b": normal_init(self.generator, gen),
                           "b2a": normal_init(self.generator, gen)})
        d_params = on_dev({"a": normal_init(self.discriminator, gen),
                           "b": normal_init(self.discriminator, gen)})
        hw = self.cfg.model.image_size
        img = (hw, hw, self.cfg.model.out_channels)
        return CycleGANState(
            g_params=g_params, d_params=d_params,
            g_opt=self.g_tx.init(g_params), d_opt=self.d_tx.init(d_params),
            ema=tree_map(torch.clone, g_params),
            pool_a=self.pool.init(img, dev, self.dtype),
            pool_b=self.pool.init(img, dev, self.dtype),
            step=0, seed=int(seed))

    # ----------------------------------------------------------------- draws
    def draw(self, state: CycleGANState, batch: int, height: int,
             width: int) -> dict:
        """The step's draws from the (seed, step) generator: crop offsets
        and flips for each batch, slots and coins for each pool."""
        gen = step_generator(state.seed, state.step)
        crop = self.cfg.model.image_size
        return {
            "aug_a": draw_augment(gen, batch, height, width, crop),
            "aug_b": draw_augment(gen, batch, height, width, crop),
            "pool_a": self.pool.draw(gen, state.pool_a, batch),
            "pool_b": self.pool.draw(gen, state.pool_b, batch),
        }

    # ------------------------------------------------------------------ step
    def _G(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.generator, params, (x,))

    def _D(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.discriminator, params, (x,))

    def _input(self, batch, aug) -> torch.Tensor:
        x = torch.as_tensor(batch).to(self.device)
        if x.dtype != torch.uint8:  # pre-augmented floats, as in JAX
            return x.to(self.dtype)
        crop = self.cfg.model.image_size
        if self.cfg.data.augment == "none":
            return center_crop_normalize(x, crop, self.dtype)
        oy, ox, flip = aug
        return augment_batch(x.contiguous(), torch.as_tensor(oy),
                             torch.as_tensor(ox), torch.as_tensor(flip), crop,
                             self.dtype)

    def _g_loss(self, gp: dict, dp: dict, real_a, real_b):
        loss = self.cfg.loss
        lam = loss.lambda_cycle
        lam_id = loss.lambda_identity * lam
        idt_a = idt_b = None
        if self.cfg.model.fused_applies and lam_id > 0:
            # one apply at 2B per generator: instance norm is per example
            fake_b, idt_b = torch.chunk(
                self._G(gp["a2b"], torch.cat([real_a, real_b], 0)), 2, 0)
            fake_a, idt_a = torch.chunk(
                self._G(gp["b2a"], torch.cat([real_b, real_a], 0)), 2, 0)
        else:
            fake_b = self._G(gp["a2b"], real_a)
            fake_a = self._G(gp["b2a"], real_b)
        rec_a = self._G(gp["b2a"], fake_b)
        rec_b = self._G(gp["a2b"], fake_a)
        adv = (L.gan_loss_g(self._D(dp["b"], fake_b), loss.gan_mode)
               + L.gan_loss_g(self._D(dp["a"], fake_a), loss.gan_mode))
        cyc = lam * (L.cycle_loss(real_a, rec_a) + L.cycle_loss(real_b, rec_b))
        total = adv + cyc
        idt = torch.zeros((), device=self.device)
        if lam_id > 0:
            if idt_b is None:
                idt_b = self._G(gp["a2b"], real_b)
                idt_a = self._G(gp["b2a"], real_a)
            idt = lam_id * (L.identity_loss(real_b, idt_b)
                            + L.identity_loss(real_a, idt_a))
            total = total + idt
        lpips = torch.zeros((), device=self.device)
        if loss.lambda_lpips > 0:
            lpips = loss.lambda_lpips * (self.perceptual_fn(real_a, rec_a)
                                         + self.perceptual_fn(real_b, rec_b))
            total = total + lpips
        return total, {"fake_a": fake_a, "fake_b": fake_b, "g_adv": adv,
                       "g_cycle": cyc, "g_idt": idt, "g_lpips": lpips}

    def _d_loss(self, dp: dict, real_a, fake_a, real_b, fake_b):
        mode = self.cfg.loss.gan_mode
        if self.cfg.model.fused_applies:
            ra, fa = torch.chunk(
                self._D(dp["a"], torch.cat([real_a, fake_a], 0)), 2, 0)
            rb, fb = torch.chunk(
                self._D(dp["b"], torch.cat([real_b, fake_b], 0)), 2, 0)
        else:
            ra, fa = self._D(dp["a"], real_a), self._D(dp["a"], fake_a)
            rb, fb = self._D(dp["b"], real_b), self._D(dp["b"], fake_b)
        la = L.gan_loss_d(ra, fa, mode)
        lb = L.gan_loss_d(rb, fb, mode)
        return la + lb, {"d_a": la, "d_b": lb}

    @staticmethod
    def _with_grad(tree: dict) -> dict:
        return tree_map(lambda t: t.detach().requires_grad_(True), tree)

    def train_step(self, state: CycleGANState, batch, draws: dict | None = None):
        """One step on ``batch = (a, b)``: uint8 (B, load, load, C) arrays or
        tensors (augmented on the device), or floats in [-1, 1] taken as
        they are. ``draws`` as ``draw`` returns them (drawn when None).
        Updates ``state`` in place and returns ``(state, metrics)``, the
        metrics as 0-dim fp32 tensors under JAX's names."""
        if draws is None:
            shape = np.shape(batch[0])
            draws = self.draw(state, shape[0], shape[1], shape[2])
        grads, metrics = self._grads(state, batch, draws)
        self._update(state, grads)
        return state, metrics

    def _grads(self, state: CycleGANState, batch, draws: dict):
        """The step's gradients at ``state``'s parameters, as trees under
        ``"g"`` and ``"d"``, and its metrics. Queries both replay pools,
        whose new state it writes into ``state``; the parameters, moments,
        EMA and step stay as they were. The D loss reads the fakes of the G
        loss, not the updated generators, so every gradient of the step can
        be taken before any update."""
        a_in, b_in = batch
        with self._precision():
            real_a = self._input(a_in, draws["aug_a"])
            real_b = self._input(b_in, draws["aug_b"])

            # ---------------- G loss (grads for g_params only)
            gp = self._with_grad(state.g_params)
            g_loss, aux = self._g_loss(gp, state.d_params, real_a, real_b)
            g_grads = torch.autograd.grad(g_loss, tree_leaves(gp))

            # ---------------- replay pools (fakes carry no graph)
            state.pool_a, d_fake_a = self.pool.query(
                state.pool_a, aux["fake_a"].detach(), *draws["pool_a"])
            state.pool_b, d_fake_b = self.pool.query(
                state.pool_b, aux["fake_b"].detach(), *draws["pool_b"])
            del aux["fake_a"], aux["fake_b"], gp

            # ---------------- D loss
            dp = self._with_grad(state.d_params)
            d_loss, d_aux = self._d_loss(dp, real_a, d_fake_a, real_b,
                                         d_fake_b)
            d_grads = torch.autograd.grad(d_loss, tree_leaves(dp))
        grads = {"g": tree_unflatten(state.g_params, g_grads),
                 "d": tree_unflatten(state.d_params, d_grads)}
        zero = torch.zeros((), device=self.device)
        metrics = {
            "g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
            "g_adv": aux["g_adv"].detach(), "g_cycle": aux["g_cycle"].detach(),
            "g_idt": aux["g_idt"].detach(),
            "g_lpips": aux["g_lpips"].detach(),
            "d_a": d_aux["d_a"].detach(), "d_b": d_aux["d_b"].detach(),
            "d_r1": zero,
            "lr": torch.tensor(self.g_tx.lr(state.step), dtype=torch.float32,
                               device=self.device),
        }
        return grads, metrics

    def _update(self, state: CycleGANState, grads: dict) -> None:
        """Adam on the generators at the schedule's LR for the count before
        it increments, the EMA of the updated generators, Adam on the
        discriminators at ``opt.d_lr_ratio``; then the step count."""
        with exact_fp32():
            self.g_tx.update(state.g_params, tree_leaves(grads["g"]),
                             state.g_opt)
            ema_update(state.ema, state.g_params, self.cfg.opt.ema_decay)
            self.d_tx.update(state.d_params, tree_leaves(grads["d"]),
                             state.d_opt)
        state.step += 1

    # ------------------------------------------------------------- translate
    def translate(self, ema: dict, x: torch.Tensor,
                  direction: str = "a2b") -> torch.Tensor:
        """[-1, 1] NHWC images -> the EMA generator's translation, computed
        in ``model.eval_dtype`` (float32, or bfloat16 with the training
        forward's casts; the output in that dtype), no gradient."""
        if direction not in ("a2b", "b2a"):
            raise ValueError(f"direction must be a2b or b2a, got {direction!r}")
        with torch.inference_mode(), self._eval_precision():
            return functional_call(self.eval_generator, ema[direction],
                                   (x.to(self.device, torch.float32),))

