"""Replay pool of generated images: the port of the JAX package's
``train/pool.py`` ``ImagePool``.

The pool is a (pool_size, H, W, C) buffer on the device plus a fill count on
the host. ``query`` takes its draws (a slot per image and a coin) as given,
so a test can inject the JAX function's draws. It reads the old buffer
before it writes, as JAX's gather-then-scatter does, and it writes in
place (the state is consumed, as JAX donates it). When two images of a batch
target one slot, the last in batch order wins, as JAX's scatter leaves it
on the CPU; the write plan is resolved on the host, so every slot is written
at most once and the result does not depend on the order of device writes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class PoolState:
    buffer: torch.Tensor  # (S, H, W, C)
    count: int            # number of valid slots


class ImagePool:
    def __init__(self, pool_size: int = 50):
        self.pool_size = pool_size

    def init(self, image_shape: tuple[int, int, int], device,
             dtype=torch.float32) -> PoolState:
        return PoolState(torch.zeros((self.pool_size,) + tuple(image_shape),
                                     dtype=dtype, device=device), 0)

    def draw(self, gen: torch.Generator, state: PoolState, batch: int):
        """(rand_idx, use_pool) as JAX draws them: a slot among the filled
        ones (slot 0 while the pool is empty) and a fair coin per image."""
        rand_idx = torch.randint(0, max(state.count, 1), (batch,),
                                 generator=gen)
        use_pool = torch.rand((batch,), generator=gen) < 0.5
        return rand_idx, use_pool

    @torch.no_grad()
    def query(self, state: PoolState, fakes: torch.Tensor, rand_idx,
              use_pool) -> tuple[PoolState, torch.Tensor]:
        """Push a batch of fakes; return (state, images for D).

        Per image: while the pool fills, append it and return it; once
        full, with ``use_pool`` return the pooled image at ``rand_idx`` and
        put the fresh one in its place, else return the fresh one."""
        if self.pool_size <= 0:
            return state, fakes
        s = self.pool_size
        buf = state.buffer
        fakes = fakes.detach().to(buf.dtype)
        idx = [int(i) for i in rand_idx]
        use = [bool(u) for u in use_pool]
        out = fakes.clone()
        targets: dict[int, int] = {}
        for i in range(fakes.shape[0]):
            slot = state.count + i
            if slot < s:
                targets[slot] = i
            elif use[i]:
                out[i].copy_(buf[idx[i]])  # the old buffer: no write yet
                targets[idx[i]] = i        # a later image overrides
        for slot, i in targets.items():
            buf[slot].copy_(fakes[i])
        return PoolState(buf, min(state.count + fakes.shape[0], s)), out
