"""Training observability: JSONL metrics and the hot loop's step and stall
timing, the port of the JAX package's ``metrics/writer.py``.

``StepTimer.throughput`` gives images/s (``images_per_sec_chip`` once
divided by the device count) and ``StepTimer.stall_pct`` the share of wall
time spent waiting on the input pipeline (``input_stall_pct``). The
TensorBoard mirror is not ported: ``tensorboard=True`` raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsWriter:
    """One JSON line per log event in ``<workdir>/<name>.jsonl``, line
    buffered, appended to (a resumed run continues the file)."""

    def __init__(self, workdir: str, name: str = "metrics",
                 tensorboard: bool = False):
        if tensorboard:
            raise NotImplementedError(
                "run.tensorboard=True: the port writes metrics.jsonl only "
                "(the tensorboard mirror is ROADMAP §1 item 14)")
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, f"{name}.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, scalars: dict[str, Any]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


class StepTimer:
    """Wall-time accounting for the hot loop.

    Per step::

        t.data_start(); batch = next(it); t.data_stop()
        state, m = train_step(state, batch)
        t.step_done(batch_images)

    ``stall_pct`` is the time blocked on the input pipeline over the wall
    time of the window since ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._data_t = 0.0
        self._data_mark = None
        self._images = 0

    def data_start(self) -> None:
        self._data_mark = time.perf_counter()

    def data_stop(self) -> None:
        if self._data_mark is not None:
            self._data_t += time.perf_counter() - self._data_mark
            self._data_mark = None

    def step_done(self, images: int) -> None:
        self._images += images

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def throughput(self) -> float:
        """Images/s over the window (divide by devices for per chip)."""
        e = self.elapsed
        return self._images / e if e > 0 else 0.0

    @property
    def stall_pct(self) -> float:
        e = self.elapsed
        return 100.0 * self._data_t / e if e > 0 else 0.0
