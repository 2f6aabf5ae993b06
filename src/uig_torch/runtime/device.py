"""Device selection for the port's entry points: the card by default."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``"cuda"`` (or None) gives ``cuda:0`` and raises when PyTorch sees no
    CUDA device; ``"cpu"`` gives the CPU, where every kernel wrapper runs its
    plain PyTorch version. There is no fallback from one to the other."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
