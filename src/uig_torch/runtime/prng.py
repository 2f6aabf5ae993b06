"""Per-step random draws of the training step, from ``torch.Generator``.

The port's counterpart of the JAX package's ``runtime/prng.py``: there,
every step derives its keys from the state's key and the step number
(``fold_step`` + ``split_named``), so a resumed run draws what an unbroken
one would. Here the step's generator is seeded from ``(seed, step)`` alone,
with the same property. torch cannot reproduce ``jax.random``'s bits, so the
values differ from JAX's; a parity test injects JAX's draws instead.
"""

from __future__ import annotations

import numpy as np
import torch


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator that depends only on ``(seed, step)``."""
    entropy = np.random.SeedSequence([int(seed), int(step)])
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(entropy.generate_state(1, np.uint64)[0]))
    return gen
