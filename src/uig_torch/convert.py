"""Carry generator weights between the flax layout and the port.

The flat flax layout is the one ``scripts/import_cyclegan_torch.py`` writes
and reads: ``np.savez`` of keys like ``params/layers_0/kernel`` and
``params/layers_9/PadConv_0/bias``. The port keeps flax's parameter names
and layouts (conv kernels HWIO), so a key maps to the port's
``layers_0.kernel`` by a rename and every array crosses unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_PREFIX = "params/"


def generator_state_from_flax(flat: dict[str, np.ndarray],
                              model: nn.Module | None = None
                              ) -> dict[str, torch.Tensor]:
    """Flat flax keys -> the port's state dict (fp32 CPU tensors). With
    ``model``, raises KeyError on any missing or unused key and ValueError
    on a shape that differs."""
    state = {}
    for key, value in flat.items():
        if not key.startswith(_PREFIX):
            raise KeyError(f"flax key {key!r} does not start with {_PREFIX!r}")
        name = key[len(_PREFIX):].replace("/", ".")
        state[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    if model is not None:
        check_state(state, model)
    return state


def flax_from_generator_state(state: dict[str, torch.Tensor]
                              ) -> dict[str, np.ndarray]:
    """The inverse: the port's state dict -> flat flax keys (numpy fp32)."""
    return {_PREFIX + name.replace(".", "/"):
            t.detach().to("cpu", torch.float32).numpy()
            for name, t in state.items()}


def check_state(state: dict[str, torch.Tensor], model: nn.Module) -> None:
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    unused = sorted(set(state) - set(expected))
    if missing or unused:
        raise KeyError(f"generator weights do not match the model: missing "
                       f"{missing}, unused {unused}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{name}: weights have shape {tuple(t.shape)}, "
                             f"model wants {tuple(expected[name].shape)}")


def load_generator_npz(path: str) -> dict[str, np.ndarray]:
    """Read the flat flax ``.npz`` of one generator (``params/...`` keys)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
