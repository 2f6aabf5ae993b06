"""Batch translate a directory of images through the port's Translator."""

from __future__ import annotations

import os

import numpy as np


def run_translate(config: str, weights: str, input_dir: str, output_dir: str,
                  direction: str = "a2b", batch_size: int = 8,
                  device: str = "cuda", overrides=()) -> int:
    """Translate every image of ``input_dir`` into ``output_dir/<stem>.png``;
    returns the number written."""
    from PIL import Image

    from uig_torch.data import FolderDataset
    from uig_torch.serving import Translator

    tr = Translator(config, weights, direction=direction,
                    batch_size=batch_size, device=device, overrides=overrides)
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
