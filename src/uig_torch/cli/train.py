"""The ``train`` and ``pack`` commands of ``python -m uig_torch.cli``."""

from __future__ import annotations


def run_train(preset: str | None, config: str | None, overrides=(),
              max_steps: int | None = None, device: str = "cuda") -> dict:
    """Train (or resume) the run of the preset, or of a ``config.json`` (as
    ``fit`` writes it), with the dotted ``--set`` overrides; its final
    metrics."""
    from uig_torch.config import apply_overrides, get_preset, load_config
    from uig_torch.train.loop import fit

    cfg = load_config(config) if config else get_preset(preset)
    return fit(apply_overrides(cfg, list(overrides)), max_steps=max_steps,
               device=device)


def run_pack(input_dir: str, output: str, load_size: int) -> int:
    """Decode an image folder once into a memmapped ``.npy``
    (``data.source=packed``); the number of images."""
    from uig_torch.data import FolderDataset, PackedDataset

    return PackedDataset.pack(FolderDataset(input_dir, load_size), output)
