"""``python -m uig_torch.cli eval-fid``: restore a run's EMA generator,
translate the eval stream, extract features on the device, and report FID
(streamed mean/cov against the real target domain's, or against
precomputed ``--ref-stats``), KID, PRDC or the Inception Score. The port of
the JAX package's ``cli/eval_fid.py`` for the CycleGAN and VQGAN families
(translate is reconstruct for VQGAN)."""

from __future__ import annotations

import numpy as np


def run_eval_fid(run_dir: str, direction: str = "a2b",
                 num_samples: int | None = None, step: int | None = None,
                 batch_size: int = 16, overrides=(), kid: bool = False,
                 prdc: bool = False, prdc_k: int = 5,
                 inception_score: bool = False, is_splits: int = 10,
                 ref_stats: str | None = None, diversity: int = 0,
                 target_domain: int | None = None, device: str = "cuda"):
    """Returns FID, or (KID mean, KID std) with ``kid``, or a {precision,
    recall, density, coverage} dict with ``prdc``, or (IS mean, IS std)
    with ``inception_score``; prints the JAX package's line for it.

    Refused: the multi-domain families (``build_trainer``) and
    ``target_domain`` (ROADMAP §1 item 10); ``diversity`` needs a
    multimodal family, and CycleGAN and VQGAN are deterministic per input,
    so it raises the JAX package's ValueError."""
    from uig_torch.cli.translate import load_run
    from uig_torch.eval.fid import (FIDStats, as_feature_fn, compute_fid,
                                    compute_kid, make_feature_fn,
                                    translation_streams)

    if ref_stats and (kid or prdc or inception_score or diversity):
        raise ValueError("--ref-stats is FID-only: KID/PRDC need the raw "
                         "real features and IS/diversity never look at reals")
    if target_domain is not None:
        raise NotImplementedError(
            "--target-domain is for the multi-domain families (stargan, "
            "starganv2), not ported yet (ROADMAP §1 item 10)")
    cfg, trainer, state = load_run(run_dir, step, overrides, device)
    n, real, fake = translation_streams(
        cfg, trainer, state, num_samples or cfg.eval.fid_num_samples,
        batch_size, direction)

    if diversity:
        if diversity < 2:
            raise ValueError("--diversity needs >=2 style seeds")
        raise ValueError(
            f"--diversity needs a multimodal family (munit|starganv2); "
            f"kind={cfg.model.kind!r} is deterministic per input")

    if inception_score:
        from uig_torch.eval.inception import init_inception
        from uig_torch.eval.is_score import compute_inception_score

        w = cfg.eval.inception_weights or None
        if not w:
            raise ValueError(
                "Inception Score needs eval.inception_weights (exported "
                "with scripts/export_weights.py inception --fc 1000); the "
                "random-feature fallback has no class head")
        with np.load(w) as loaded:
            if "params/fc/kernel" not in loaded:
                raise ValueError(
                    f"{w} has no fc head — re-export with --fc 1000")
            nc = int(loaded["params/fc/kernel"].shape[1])
        apply_fn, model = init_inception(w, num_classes=nc,
                                         device=trainer.device)
        logits_fn = as_feature_fn(lambda x: apply_fn(model, x))
        mean, std = compute_inception_score(fake, logits_fn, splits=is_splits)
        print(f"IS[inception_fc{nc}] over {n} samples ({direction}, "
              f"{is_splits} splits): {mean:.4f} ± {std:.4f}")
        return mean, std

    feature_fn, name = make_feature_fn(cfg, trainer.device)
    if prdc:
        from uig_torch.eval.prdc import compute_prdc

        out = compute_prdc(real, fake, feature_fn, k=prdc_k)
        print(f"PRDC[{name}] over {n} samples ({direction}, k={prdc_k}): "
              + " ".join(f"{k_}={v:.4f}" for k_, v in out.items()))
        return out
    if kid:
        mean, std = compute_kid(real, fake, feature_fn)
        print(f"KID[{name}] over {n} samples ({direction}): "
              f"{mean:.6f} ± {std:.6f}")
        return mean, std
    st = None
    if ref_stats:
        st, st_name, st_size = FIDStats.load(ref_stats)
        if st_name != name:
            raise ValueError(
                f"--ref-stats {ref_stats} was computed with extractor "
                f"{st_name!r} but this run resolves to {name!r} — recompute "
                "with `uig fid-stats` under the same eval settings")
        if st_size != cfg.model.image_size:
            raise ValueError(
                f"--ref-stats {ref_stats} was computed at image_size "
                f"{st_size}, this run evaluates at {cfg.model.image_size}")
    fid = compute_fid(real, fake, feature_fn, real_stats=st)
    against = "" if st is None else f" vs precomputed real stats (n={st.n})"
    print(f"FID[{name}] over {n} samples{against} ({direction}): {fid:.4f}")
    return fid
