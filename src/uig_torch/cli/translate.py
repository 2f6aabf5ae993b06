"""Batch translate a directory of images through the port's Translator;
``load_run``, the restore of a training run that the eval commands share."""

from __future__ import annotations

import os

import numpy as np


def load_run(run_dir: str, step: int | None = None, overrides=(),
             device: str = "cuda"):
    """(cfg, trainer, state) of a training run of the port (``fit``): its
    ``config.json`` with the dotted ``overrides``, the trainer of its kind
    on ``device`` (``build_trainer``) and the state of checkpoint ``step``
    (default: the newest) under ``ckpt/``."""
    from uig_torch.checkpoint import CheckpointManager
    from uig_torch.config import apply_overrides, load_config
    from uig_torch.train.loop import build_trainer

    cfg = load_config(os.path.join(run_dir, "config.json"))
    if overrides:
        cfg = apply_overrides(cfg, list(overrides))
    trainer = build_trainer(cfg, device)
    state = trainer.init_state(cfg.run.seed)
    state, _, _ = CheckpointManager(os.path.join(run_dir, "ckpt")).restore(
        state, step=step)
    return cfg, trainer, state


def run_translate(config: str | None, weights: str | None, input_dir: str,
                  output_dir: str, direction: str = "a2b",
                  batch_size: int = 8, device: str = "cuda", overrides=(),
                  run_dir: str | None = None, step: int | None = None) -> int:
    """Translate every image of ``input_dir`` into ``output_dir/<stem>.png``
    through ``weights`` under ``config``, or through the EMA generator of a
    training run's checkpoint (``run_dir``, ``step``: default the newest);
    returns the number written."""
    from PIL import Image

    from uig_torch.data import FolderDataset
    from uig_torch.serving import Translator

    if run_dir is not None:
        tr = Translator.from_run_dir(run_dir, step, direction, batch_size,
                                     device, overrides)
    else:
        tr = Translator(config, weights, direction=direction,
                        batch_size=batch_size, device=device,
                        overrides=overrides)
    ds = FolderDataset(input_dir, tr.load)
    names = ds.names()
    os.makedirs(output_dir, exist_ok=True)
    done = 0
    for start in range(0, len(ds), batch_size):
        idxs = range(start, min(start + batch_size, len(ds)))
        out = tr(np.stack([ds[i] for i in idxs]))
        for i, img in zip(idxs, out):
            Image.fromarray(img).save(os.path.join(output_dir, f"{names[i]}.png"))
            done += 1
    return done
