"""VQGAN trainer, in PyTorch: the port of the JAX package's
``train/vqgan_trainer.py`` ``VQGANTrainer`` for one device.

One autoencoder with a shared codebook trains over the union of both
domains: each step concatenates the augmented A and B halves. One
``train_step`` computes what ``_device_step`` computes, in its order:

1. augment both uint8 batches on the device (the augment kernel), then
   concatenate A and B;
2. the generator apply; the L1 reconstruction loss, with
   ``loss.lambda_lpips > 0`` the term lambda_lpips * LPIPS(x, recon), and
   the hinge (or the configured mode) adversarial loss of D on the
   reconstruction; the NLL is rec + the LPIPS term;
3. with ``loss.vq_adaptive_weight``, the weight
   |grad_W nll| / (|grad_W adv| + 1e-4), clipped to [0, 1e4], at the
   decoder's last conv kernel W. JAX takes both gradients with one vjp of a
   separate forward; here both come from the main forward's graph
   (``torch.autograd.grad(..., retain_graph=True)``), the same numbers
   without a second forward, so a step runs each attention forward once;
4. total = nll + codebook + beta * commitment + adv_w * weight * adv, with
   adv_w = ``loss.lambda_vq_adv`` once the step reaches
   ``loss.vq_disc_start`` and 0 before; its gradient for the generator;
5. Adam on the generator at the schedule's LR, then the EMA;
6. the D loss on [real union, reconstruction] and Adam on D, gated whole
   (parameters and Adam state) until ``loss.vq_disc_start``. The gated-off
   D work is skipped: JAX computes and discards it, so state and metrics
   are the same.

As in the CycleGAN trainer, every gradient is taken at the state's
parameters before any update (``_grads``, then ``_update``), the state is
updated in place, the draws come from (seed, step) or are passed in, and on
the card the step runs without TF32 and with deterministic algorithms
(``serving.exact_fp32``, in bf16 ``serving.exact_bf16``).
``model.compute_dtype`` is float32 or bfloat16 (the preset's default): in
bf16 the augmented batches, the generator's and D's activations and the
reconstruction are bf16, with JAX's explicit casts; parameters and their
gradients, Adam, the EMA, the quantizer and its codebook terms, the losses
and the adaptive weight's gradient norms are fp32. ``translate`` and
``decode_codes`` run a generator in ``model.eval_dtype`` (float32, or
bfloat16 under ``serving.exact_bf16``).
LPIPS is built and passed as in the CycleGAN trainer (``perceptual_fn``).
Not ported yet, and refused: ``model.fused_applies``,
``opt.grad_accum > 1``, ``model.remat``, weight decay, gradient clipping
and SGD.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from uig_torch.convert import generator_state_from_flax, seeded_flax
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
from uig_torch.train.state import (Adam, VQGANState, normal_init, tree_leaves,
                                   tree_map, tree_unflatten)


def _with_grad(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_(True)


def _refuse_unported(cfg) -> None:
    if cfg.model.kind != "vqgan":
        raise ValueError(f"VQGANTrainer needs model.kind=vqgan, got "
                         f"{cfg.model.kind!r}")
    unported = {
        "model.fused_applies": cfg.model.fused_applies,
        "opt.grad_accum > 1": cfg.opt.grad_accum > 1,
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"VQGANTrainer: {what} is not ported "
                                      "yet (ROADMAP); set it off")
    if cfg.data.augment not in ("pallas", "xla", "none"):
        raise ValueError(f"unknown augment impl {cfg.data.augment!r}")


class VQGANTrainer:
    """The shared-codebook VQGAN autoencoder and one PatchGAN
    discriminator.

      init_state(seed)                 -> VQGANState
      train_step(state, (a, b), draws) -> (state, metrics)
      translate(ema, x)                -> reconstructions
      decode_codes(ema, codes)         -> images

    ``perceptual_fn`` as in ``CycleGANTrainer``.
    """

    directions = ("a2b",)  # translate is reconstruct

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
        # the decoder's final conv kernel: the adaptive weight's leaf
        last = max((s for s in self.generator.decoder.plan
                    if s.startswith("Conv_")), key=lambda s: int(s[5:]))
        self.last_kernel = f"decoder.{last}.kernel"
        self.g_tx = Adam(cfg.opt)
        self.d_tx = Adam(cfg.opt, lr_scale=cfg.opt.d_lr_ratio)

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int) -> VQGANState:
        """Generator weights by flax's initializers
        (``convert.seeded_flax``), the discriminator's normal(0.02),
        zero moments, the EMA a copy of the generator."""
        dev = self.device
        g_params = tree_map(lambda t: t.to(dev), generator_state_from_flax(
            seeded_flax(self.generator, seed), self.generator))
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        d_params = tree_map(lambda t: t.to(dev),
                            normal_init(self.discriminator, gen))
        return VQGANState(
            g_params=g_params, d_params=d_params,
            g_opt=self.g_tx.init(g_params), d_opt=self.d_tx.init(d_params),
            ema={"a2b": tree_map(torch.clone, g_params)}, step=0,
            seed=int(seed))

    # ----------------------------------------------------------------- draws
    def draw(self, state: VQGANState, batch: int, height: int,
             width: int) -> dict:
        """The step's crop offsets and flips for each domain's batch, from
        the (seed, step) generator."""
        gen = step_generator(state.seed, state.step)
        crop = self.cfg.model.image_size
        return {"aug_a": draw_augment(gen, batch, height, width, crop),
                "aug_b": draw_augment(gen, batch, height, width, crop)}

    # ------------------------------------------------------------------ step
    def _G(self, params: dict, x: torch.Tensor):
        return functional_call(self.generator, params, (x,))

    def _D(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.discriminator, params, (x,))

    def _input(self, batch, aug) -> torch.Tensor:
        """The batch in the compute dtype: uint8 augmented by the kernel
        into it, floats cast to it, as in JAX."""
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

    def train_step(self, state: VQGANState, batch, draws: dict | None = None):
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

    def _grads(self, state: VQGANState, batch, draws: dict):
        """The step's gradients at ``state``'s parameters (``"g"``, and
        ``"d"`` or None while D is gated off) and its metrics; the state is
        not changed."""
        loss, m = self.cfg.loss, self.cfg.model
        on = state.step >= loss.vq_disc_start
        dev = self.device
        with self._precision():
            x = torch.cat([self._input(batch[0], draws["aug_a"]),
                           self._input(batch[1], draws["aug_b"])], 0)

            # ---------------- G loss (grads for g_params only)
            gp = tree_map(_with_grad, state.g_params)
            recon, vq = self._G(gp, x)
            rec = L.l1_loss(x, recon)
            lpips = torch.zeros((), device=dev)
            if loss.lambda_lpips > 0:
                lpips = loss.lambda_lpips * self.perceptual_fn(x, recon)
            nll = rec + lpips
            adv = L.gan_loss_g(self._D(state.d_params, recon), loss.gan_mode)
            lam = torch.ones((), device=dev)
            if loss.vq_adaptive_weight:
                w = gp[self.last_kernel]
                g_nll, = torch.autograd.grad(nll, w, retain_graph=True)
                g_adv, = torch.autograd.grad(adv, w, retain_graph=True)
                lam = torch.clamp(torch.linalg.vector_norm(g_nll) / (
                    torch.linalg.vector_norm(g_adv) + 1e-4), 0.0, 1e4)
            codebook = vq.codebook_loss + m.vq_beta * vq.commitment_loss
            total = rec + codebook
            if on:  # adv_w = 0 before vq_disc_start: the term adds 0
                total = total + loss.lambda_vq_adv * lam * adv
            total = total + lpips
            g_grads = tree_unflatten(state.g_params, torch.autograd.grad(
                total, tree_leaves(gp)))
            del gp

            # ---------------- D loss (gated whole until vq_disc_start)
            d_grads, d_loss = None, torch.zeros((), device=dev)
            if on:
                fake = recon.detach()
                dp = tree_map(_with_grad, state.d_params)
                d_loss = L.gan_loss_d(self._D(dp, x), self._D(dp, fake),
                                      loss.gan_mode)
                d_grads = tree_unflatten(state.d_params, torch.autograd.grad(
                    d_loss, tree_leaves(dp)))
        metrics = {
            "g_loss": total.detach(), "d_loss": d_loss.detach(),
            "rec": rec.detach(), "codebook": codebook.detach(),
            "g_adv": adv.detach(), "perplexity": vq.perplexity.detach(),
            "lpips": lpips.detach(),
            "lambda_adapt": lam.detach(),
            "lr": torch.tensor(self.g_tx.lr(state.step), dtype=torch.float32,
                               device=dev),
        }
        return {"g": g_grads, "d": d_grads}, metrics

    def _update(self, state: VQGANState, grads: dict) -> None:
        """Adam on the generator at the schedule's LR for the count before
        it increments, the EMA of the updated generator, Adam on D unless
        it is gated off; then the step count."""
        with exact_fp32():
            self.g_tx.update(state.g_params, tree_leaves(grads["g"]),
                             state.g_opt)
            ema_update(state.ema["a2b"], state.g_params,
                       self.cfg.opt.ema_decay)
            if grads["d"] is not None:
                self.d_tx.update(state.d_params, tree_leaves(grads["d"]),
                                 state.d_opt)
        state.step += 1

    # ------------------------------------------------------------- serving
    def translate(self, ema: dict, x: torch.Tensor,
                  direction: str = "a2b") -> torch.Tensor:
        """VQGAN 'translation' is reconstruction through the shared codebook
        in either direction (as in the JAX package, ``direction`` picks no
        weights): [-1, 1] NHWC images -> the EMA generator's
        reconstructions, computed in ``model.eval_dtype`` (the output in
        it), no gradient."""
        if direction not in ("a2b", "b2a"):
            raise ValueError(f"direction must be a2b or b2a, got {direction!r}")
        with torch.inference_mode(), self._eval_precision():
            return functional_call(self.eval_generator, ema["a2b"],
                                   (x.to(self.device, torch.float32),))[0]

    def decode_codes(self, ema: dict, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, h, w) -> the EMA decoder's images of those codewords,
        in ``model.eval_dtype``."""
        p = ema["a2b"]
        dec = {k[len("decoder."):]: t for k, t in p.items()
               if k.startswith("decoder.")}
        with torch.inference_mode(), self._eval_precision():
            z = p["quantizer.codebook"][codes.to(self.device).long()]
            return functional_call(self.eval_generator.decoder, dec, (z,))
