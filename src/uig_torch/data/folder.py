"""A directory of images for translate: PIL RGB decode, bilinear resize to
``load_size``, uint8 HWC, as the JAX package's FolderDataset does with its
PIL decoder."""

from __future__ import annotations

import os

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def decode_resize(data, load_size: int) -> np.ndarray:
    """A path or file object -> uint8 (load_size, load_size, 3)."""
    from PIL import Image

    with Image.open(data) as im:
        im = im.convert("RGB").resize((load_size, load_size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


class FolderDataset:
    def __init__(self, root: str, load_size: int):
        self.root = root
        self.load_size = load_size
        self.files = sorted(os.path.join(root, f) for f in os.listdir(root)
                            if f.lower().endswith(IMG_EXTS))
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        return decode_resize(self.files[idx], self.load_size)

    def names(self) -> list[str]:
        """Output file stems: the basenames, or zero-padded indices where
        two files share a stem."""
        stems = [os.path.splitext(os.path.basename(f))[0] for f in self.files]
        if len(set(stems)) == len(stems):
            return stems
        return [f"{i:06d}" for i in range(len(stems))]
