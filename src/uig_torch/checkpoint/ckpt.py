"""Checkpoints and exact resume, in the port's own format: the counterpart
of the JAX package's ``checkpoint/ckpt.py`` (orbax there).

A checkpoint is one directory per step, ``<directory>/<step>/``:

* ``state.pt``: every tensor of the train state (``CycleGANState``,
  ``VQGANState``, ``CUTState`` or ``DCLGANState``) under its path
  (``g_params/a2b/layers_0.kernel``, ``g_opt/mu/...``, ``pool_a/buffer``,
  ...), on the CPU, in its exact dtype
  (``torch.save`` of a flat dict; read back with ``weights_only=True``);
* ``meta.json``: the state's integers (``step``, ``seed``, both Adam counts,
  both pool counts), the numpy arrays of ``carried`` (JAX fields the port
  keeps), the input pipeline's cursor (``data_state``) and ``extra``.

A save writes a temporary directory and renames it into place with
``os.replace``, so a process killed mid-save leaves the checkpoints before
it readable (the manager removes the leftover at its first save).
Saves are synchronous: ``wait`` and ``close`` have nothing to wait for.

Retention is orbax's, which the JAX package's manager uses: without
``best_metric`` the last ``keep`` checkpoints stay. With it (``fit`` sets
``best_metric="fid"`` when ``eval.fid_every`` is on) a save may carry
``metrics`` (kept in ``meta.json``), and once there are more than ``keep``
checkpoints the ``keep`` with the lowest metric stay (ties keep the later
save), and so does every checkpoint saved without metrics: orbax's
``BestN`` with ``keep_checkpoints_without_metrics=True``. So the newest
checkpoint may go while older ones stay, and ``latest_step`` is the newest
that stays.

Restore puts every tensor on the device of the template's tensor, and
checks names, shapes and dtypes against it, so a resumed run continues bit
for bit.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import fields, is_dataclass

import numpy as np
import torch

STATE_FILE = "state.pt"
META_FILE = "meta.json"
_TMP = ".tmp-"


def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def state_to_flat(state) -> tuple[dict, dict, dict]:
    """A train state -> (tensors, integers, numpy arrays), each a flat dict
    keyed by the path of its leaf."""
    tensors, ints, arrays = {}, {}, {}

    def walk(obj, name):
        if is_dataclass(obj):
            for f in fields(obj):
                walk(getattr(obj, f.name), _join(name, f.name))
        elif isinstance(obj, dict):
            for k in sorted(obj):
                walk(obj[k], _join(name, k))
        elif isinstance(obj, torch.Tensor):
            tensors[name] = obj
        elif isinstance(obj, np.ndarray | np.generic):
            arrays[name] = np.asarray(obj)
        elif isinstance(obj, int) and not isinstance(obj, bool):
            ints[name] = obj
        else:
            raise TypeError(f"checkpoint: cannot store {name} of type "
                            f"{type(obj).__name__}")

    walk(state, "")
    return tensors, ints, arrays


def state_from_flat(template, tensors: dict, ints: dict, arrays: dict):
    """The inverse of ``state_to_flat`` in the structure of ``template``:
    each tensor on its template tensor's device, with the same shape and
    dtype. A dict the template leaves empty (``carried``) takes the keys the
    checkpoint has under it; any other key must match."""
    used = set()
    stored = set(tensors) | set(ints) | set(arrays)

    def children(name):
        pre = name + "/"
        return {k[len(pre):].split("/", 1)[0] for k in stored
                if k.startswith(pre)}

    def build(tmpl, name):
        if is_dataclass(tmpl):
            return type(tmpl)(**{f.name: build(getattr(tmpl, f.name),
                                                _join(name, f.name))
                                 for f in fields(tmpl)})
        if isinstance(tmpl, dict):
            keys = children(name)
            if tmpl and keys != set(tmpl):
                raise KeyError(
                    f"checkpoint: {name} holds {sorted(keys - set(tmpl))[:5]} "
                    f"the model does not, and lacks "
                    f"{sorted(set(tmpl) - keys)[:5]}")
            return {k: build(tmpl.get(k), _join(name, k)) for k in sorted(keys)}
        used.add(name)
        if name in arrays:
            return arrays[name]
        if name in ints:
            return ints[name]
        if name not in tensors:
            raise KeyError(f"checkpoint: no entry {name}")
        t = tensors[name]
        if tmpl is not None and (t.shape != tmpl.shape
                                 or t.dtype != tmpl.dtype):
            raise ValueError(f"checkpoint: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, the model wants "
                             f"{tmpl.dtype} {tuple(tmpl.shape)}")
        # a copy: never a view of the mapped file the step then updates
        return t.to(tmpl.device, copy=True) if tmpl is not None else t.clone()

    state = build(template, "")
    if used != stored:
        raise KeyError(f"checkpoint: entries the state has no place for: "
                       f"{sorted(stored - used)[:5]}")
    return state


def _array_json(a: np.ndarray) -> dict:
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "data": a.ravel().tolist()}


def _array_from_json(d: dict) -> np.ndarray:
    return np.asarray(d["data"], dtype=np.dtype(d["dtype"])).reshape(d["shape"])


def preserved(infos: list, keep: int, best_metric: str | None = None
              ) -> list[bool]:
    """Which of ``infos`` ((step, metrics or None), in step order) orbax's
    default preservation policy keeps: ``LatestN(keep)`` without
    ``best_metric``, else ``BestN(keep)`` for ``best_mode="min"``, ranking
    by ``metrics.get(best_metric, inf)`` and keeping every checkpoint saved
    without metrics."""
    if len(infos) <= keep:
        return [True] * len(infos)
    if best_metric is None:
        return [i >= len(infos) - keep for i in range(len(infos))]
    ranked = sorted(((i, m) for i, (_, m) in enumerate(infos)
                     if m is not None),
                    key=lambda im: im[1].get(best_metric, float("inf")),
                    reverse=True)
    keep_idx = {i for i, _ in ranked[-keep:]}
    keep_idx |= {i for i, (_, m) in enumerate(infos) if m is None}
    return [i in keep_idx for i in range(len(infos))]


class CheckpointManager:
    """The checkpoints of one run under ``directory``: the last ``keep``,
    or with ``best_metric`` the ``keep`` lowest by it and those saved
    without metrics (module docstring)."""

    def __init__(self, directory: str, keep: int = 3,
                 best_metric: str | None = None):
        if keep < 1:
            raise ValueError(f"run.ckpt_keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.best_metric = best_metric
        self._swept = False

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isfile(os.path.join(self.directory, n,
                                                      META_FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> dict | None:
        """The metrics checkpoint ``step`` was saved with, or None."""
        with open(os.path.join(self.path(step), META_FILE)) as f:
            return json.load(f).get("metrics")

    def save(self, step: int, state, data_state: dict | None = None,
             extra: dict | None = None, metrics: dict | None = None) -> str:
        """Write ``state`` with the pipeline cursor ``data_state``, a JSON
        ``extra`` and, when the manager has a ``best_metric``, ``metrics``
        as checkpoint ``step``; then apply the retention. Returns its
        directory (gone if the retention dropped it)."""
        tensors, ints, arrays = state_to_flat(state)
        meta = {"step": int(step), "ints": ints,
                "arrays": {k: _array_json(a) for k, a in arrays.items()},
                "data_state": data_state or {}, "extra": extra or {}}
        if self.best_metric is not None and metrics is not None:
            meta["metrics"] = {k: float(v) for k, v in metrics.items()}
        if not self._swept:  # a killed save's leftovers go at the first save
            os.makedirs(self.directory, exist_ok=True)
            for name in os.listdir(self.directory):
                if name.startswith(_TMP):
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
            self._swept = True
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{os.getpid()}")
        os.makedirs(tmp)
        torch.save({k: t.detach().cpu() for k, t in tensors.items()},
                   os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        final = self.path(step)
        old = None
        if os.path.exists(final):  # a second save at one step replaces it
            old = os.path.join(self.directory, f"{_TMP}old-{step}")
            os.replace(final, old)
        os.replace(tmp, final)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        steps = self.all_steps()
        infos = [(s, self.metrics(s) if self.best_metric else None)
                 for s in steps]
        for s, kept in zip(steps, preserved(infos, self.keep,
                                            self.best_metric)):
            if not kept:
                shutil.rmtree(self.path(s), ignore_errors=True)
        return final

    def read(self, step: int | None = None) -> tuple[dict, dict]:
        """(tensors on the CPU, memory-mapped; meta) of checkpoint ``step``
        (default: the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self.path(step)
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        tensors = torch.load(os.path.join(path, STATE_FILE),
                             map_location="cpu", weights_only=True, mmap=True)
        return tensors, meta

    def restore(self, state_template, step: int | None = None):
        """(state, data_state, extra) of checkpoint ``step`` (default: the
        latest), in the structure and on the devices of
        ``state_template`` (a trainer's ``init_state``)."""
        tensors, meta = self.read(step)
        arrays = {k: _array_from_json(v) for k, v in meta["arrays"].items()}
        state = state_from_flat(state_template, tensors, meta["ints"], arrays)
        return state, meta.get("data_state", {}), meta.get("extra", {})

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release: every save has finished when it returns."""


def dump_run_config(cfg_dict: dict, workdir: str) -> None:
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2, sort_keys=True)
