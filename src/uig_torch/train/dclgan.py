"""DCLGAN trainer, in PyTorch: the port of the JAX package's
``train/dclgan_trainer.py`` ``DCLGANTrainer`` for one device.

Two generators (a2b, b2a), each with its own projection heads, and two
discriminators; no cycle loss. Each direction is held by a dual PatchNCE:
for a2b the keys are patches of ``real_a`` through G_a2b's encoder and its
heads, the queries patches of ``fake_b`` through G_b2a's encoder and its
heads (each encoder only embeds images of its own input domain); b2a
likewise. The G loss is the LSGAN (or configured) adversarial terms both
ways + lambda_nce * (NCE_a + NCE_b) + ``loss.lambda_identity`` (an
absolute weight) * the L1 identity terms. Then both replay pools, the D
loss, Adam on both branches (generators and heads, one Adam) and on both
discriminators, and the EMA of both generators.

The keys are the features of the full apply that makes each translation
(``with_features``): the same function of the same parameters as JAX's
separate encoder apply, which XLA merges with it. The queries need an
encoder-only apply of the translation through the other generator.
``model.fused_applies`` raises JAX's ValueError. Patch ids, pools and
crops are draws, as in ``train/cut.py``; the refusals are CUT's.
"""

from __future__ import annotations

import torch

from uig_torch.kernels.augment import draw_augment
from uig_torch.runtime.prng import step_generator
from uig_torch.serving import exact_fp32
from uig_torch.train import losses as L
from uig_torch.train.cut import ContrastiveBase, refuse_unported
from uig_torch.train.ema import ema_update
from uig_torch.train.state import (DCLGANState, normal_init, tree_leaves,
                                   tree_map, tree_unflatten)


class DCLGANTrainer(ContrastiveBase):
    """Two generators with their heads (a2b, b2a) and two discriminators
    (a, b).

      init_state(seed)                    -> DCLGANState
      train_step(state, (a, b), draws)    -> (state, metrics)
      translate(ema, x, direction)        -> translated images
    """

    directions = ("a2b", "b2a")

    def __init__(self, cfg, device: str = "cuda"):
        refuse_unported(cfg, "DCLGANTrainer")
        if cfg.model.fused_applies:
            raise ValueError(
                "model.fused_applies is not supported for kind=dclgan: "
                "batching the NCE encoder passes with the generator applies "
                "defeats XLA's CSE of the shared encoder half (measured -12% "
                "for CUT, BASELINE.md round 3)")
        self._build(cfg, device)

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int) -> DCLGANState:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        g_params = self._on_dev({d: self._branch_init(gen)
                                 for d in self.directions})
        d_params = self._on_dev({"a": normal_init(self.discriminator, gen),
                                 "b": normal_init(self.discriminator, gen)})
        hw = self.cfg.model.image_size
        img = (hw, hw, self.cfg.model.out_channels)
        return DCLGANState(
            g_params=g_params, d_params=d_params,
            g_opt=self.g_tx.init(g_params), d_opt=self.d_tx.init(d_params),
            ema={d: tree_map(torch.clone, g_params[d]["gen"])
                 for d in self.directions},
            pool_a=self.pool.init(img, self.device, self.dtype),
            pool_b=self.pool.init(img, self.device, self.dtype),
            step=0, seed=int(seed))

    # ----------------------------------------------------------------- draws
    def draw(self, state: DCLGANState, batch: int, height: int,
             width: int) -> dict:
        """The step's draws from the (seed, step) generator: crop offsets
        and flips for each batch, slots and coins for each pool, and each
        tap's patch ids for NCE_a and NCE_b (drawn on the trainer's
        device)."""
        gen = step_generator(state.seed, state.step)
        crop = self.cfg.model.image_size
        return {
            "aug_a": draw_augment(gen, batch, height, width, crop),
            "aug_b": draw_augment(gen, batch, height, width, crop),
            "pool_a": self.pool.draw(gen, state.pool_a, batch),
            "pool_b": self.pool.draw(gen, state.pool_b, batch),
            "nce_a": self._patch_ids(gen, batch),
            "nce_b": self._patch_ids(gen, batch),
        }

    # ------------------------------------------------------------------ step
    def _g_loss(self, gp: dict, dp: dict, real_a, real_b, draws: dict):
        loss = self.cfg.loss
        ga, gb = gp["a2b"], gp["b2a"]
        fake_b, fk_a = self._G_features(ga["gen"], real_a)
        fake_a, fk_b = self._G_features(gb["gen"], real_b)
        adv = (L.gan_loss_g(self._D(dp["b"], fake_b), loss.gan_mode)
               + L.gan_loss_g(self._D(dp["a"], fake_a), loss.gan_mode))
        # keys through the source branch, queries through the other one
        nce_a = self._nce(ga["heads"], gb["heads"], fk_a,
                          self._G_encode(gb["gen"], fake_b), draws["nce_a"])
        nce_b = self._nce(gb["heads"], ga["heads"], fk_b,
                          self._G_encode(ga["gen"], fake_a), draws["nce_b"])
        total = adv + loss.lambda_nce * (nce_a + nce_b)
        lam_id = loss.lambda_identity
        idt = torch.zeros((), device=self.device)
        if lam_id > 0:
            idt_b = self._G(ga["gen"], real_b)
            idt_a = self._G(gb["gen"], real_a)
            idt = lam_id * (L.identity_loss(real_b, idt_b)
                            + L.identity_loss(real_a, idt_a))
            total = total + idt
        return total, {"fake_a": fake_a, "fake_b": fake_b, "g_adv": adv,
                       "nce_a": nce_a, "nce_b": nce_b, "g_idt": idt}

    def _grads(self, state: DCLGANState, batch, draws: dict):
        """The step's gradients at ``state``'s parameters (``"g"``: both
        branches, ``"d"``: both discriminators) and its metrics; queries
        both replay pools, whose new state it writes into ``state``."""
        a_in, b_in = batch
        mode = self.cfg.loss.gan_mode
        with self._precision():
            real_a = self._input(a_in, draws["aug_a"])
            real_b = self._input(b_in, draws["aug_b"])

            gp = self._with_grad(state.g_params)
            g_loss, aux = self._g_loss(gp, state.d_params, real_a, real_b,
                                       draws)
            g_grads = torch.autograd.grad(g_loss, tree_leaves(gp))

            state.pool_a, d_fake_a = self.pool.query(
                state.pool_a, aux.pop("fake_a").detach(), *draws["pool_a"])
            state.pool_b, d_fake_b = self.pool.query(
                state.pool_b, aux.pop("fake_b").detach(), *draws["pool_b"])
            del gp

            dp = self._with_grad(state.d_params)
            la = L.gan_loss_d(self._D(dp["a"], real_a),
                              self._D(dp["a"], d_fake_a), mode)
            lb = L.gan_loss_d(self._D(dp["b"], real_b),
                              self._D(dp["b"], d_fake_b), mode)
            d_loss = la + lb
            d_grads = torch.autograd.grad(d_loss, tree_leaves(dp))
        grads = {"g": tree_unflatten(state.g_params, g_grads),
                 "d": tree_unflatten(state.d_params, d_grads)}
        metrics = {k: aux[k].detach() for k in ("g_adv", "nce_a", "nce_b",
                                                "g_idt")}
        metrics.update(
            g_loss=g_loss.detach(), d_loss=d_loss.detach(), d_a=la.detach(),
            d_b=lb.detach(), d_r1=torch.zeros((), device=self.device),
            lr=torch.tensor(self.g_tx.lr(state.step), dtype=torch.float32,
                            device=self.device))
        return grads, metrics

    def _update(self, state: DCLGANState, grads: dict) -> None:
        """Adam on both branches, the EMA of both generators, Adam on both
        discriminators; then the step count."""
        with exact_fp32():
            self.g_tx.update(state.g_params, tree_leaves(grads["g"]),
                             state.g_opt)
            ema_update(state.ema, {d: state.g_params[d]["gen"]
                                   for d in self.directions},
                       self.cfg.opt.ema_decay)
            self.d_tx.update(state.d_params, tree_leaves(grads["d"]),
                             state.d_opt)
        state.step += 1

    # ------------------------------------------------------------- translate
    def translate(self, ema: dict, x: torch.Tensor,
                  direction: str = "a2b") -> torch.Tensor:
        """[-1, 1] NHWC images -> the EMA generator of ``direction``'s
        translation in ``model.eval_dtype``, no gradient."""
        if direction not in self.directions:
            raise ValueError(f"direction must be one of {self.directions}")
        return self._translate(ema, x, direction)
