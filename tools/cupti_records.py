"""Which device records torch.profiler loses, and whether the kernels ran.

The slice's translate apply (``cyclegan256_dp`` at batch 8, fp32, the
seeded flax weights of ``chip_smoke.seeded_flax_weights``; 5 launches of
the norm forward K2f a call) is profiled in captures of one call each,
three without and three with a device spin of ~2 ms at each end of the
capture window (``torch.cuda._sleep``), at five points of one process:

  fresh    before any other work;
  steps    after 40 steps of ``fastcut256`` as published (bf16, batch 16)
           with no profiler on;
  profiled after one profiled step of the same trainer;
  idle     after IDLE_S seconds of the host sleeping;
  cut      after ``chip_smoke.phase_cut`` (the three contrastive trainers
           at batch 16, their checks and profiled steps), the phase after
           which the smoke's slice profile lost K2f records.

Each capture's chrome trace gives every launch call of the CUDA APIs
(``cudaLaunchKernel``, ``cuLaunchKernel``, ...) and every
kernel record, joined by their correlation ids: a launch without a record
was lost by the profiler. The capture reports the lost launches (their
index among the call's launches, their API and, where a later capture of
the same call kept it, the kernel's name), the K2f records against the
wrapper's launch count, and whether the apply's output equals the first
apply's byte for byte while every K2f output is pre-filled with NaN, so
that a launch that did not run shows in the output whatever the profiler
recorded. It also checks the norm forward's counters are back at 0.

    python3 tools/cupti_records.py

One JSON line a capture, then a summary, after the card's name and power
limit; exits non-zero if an output differs or a counter is left set.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's ~1.98 GHz
STEPS = 40
IDLE_S = 60
CAPTURES = 3


def nan_filled_norm_outputs():
    """Every K2f output pre-filled with NaN (a proxy for ``torch`` in the
    wrapper's module whose ``empty_like`` fills)."""
    import torch

    import uig_torch.kernels.norm as norm

    class Proxy:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def empty_like(x, *a, **kw):
            return torch.full_like(x, float("nan"), *a, **kw)

    norm.torch = Proxy()


def capture(fn, spin: bool) -> tuple:
    """(the output of one call of ``fn``, its launches, its lost records,
    its K2f records, the wrappers' counts) under one profiler capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uig_torch import kernels as K

    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        out = fn()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    counted = K.launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = json.load(open(path))["traceEvents"]
    launches = sorted(
        (e for e in events if e.get("cat", "").startswith("cuda_")
         and "Launch" in e.get("name", "")), key=lambda e: e["ts"])
    kernels = {e["args"].get("correlation"): e for e in events
               if e.get("cat") == "kernel"}
    if spin:  # the spins' own launches and records
        launches = launches[1:-1]
    lost = [{"index": i, "of": len(launches), "api": e["name"],
             "correlation": e["args"].get("correlation")}
            for i, e in enumerate(launches)
            if e["args"].get("correlation") not in kernels]
    order = [kernels[e["args"]["correlation"]]["name"]
             if e["args"].get("correlation") in kernels else None
             for e in launches]
    k2f = sum(1 for e in kernels.values() if "in_fwd_kernel" in e["name"])
    return out, order, lost, k2f, counted


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from uig_torch import kernels as K
    from uig_torch.config import get_preset
    from uig_torch.kernels import norm
    from uig_torch.serving import Translator
    from uig_torch.train.loop import build_trainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t_start = time.perf_counter()
    nan_filled_norm_outputs()
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "g_a2b.npz")
        cs.seeded_flax_weights(weights)
        tr = Translator(cs.PRESET, weights, batch_size=cs.BATCH)
    raw = np.random.default_rng(cs.SEED + 1).integers(
        0, 256, (cs.BATCH, tr.load, tr.load, 3), dtype=np.uint8)
    first = tr(raw)
    names: dict = {}  # launch index -> kernel name, from whole captures
    rows, bad = [], []

    def captures(point: str) -> None:
        for spin in (False, True):
            for i in range(CAPTURES):
                out, order, lost, k2f, counted = capture(lambda: tr(raw),
                                                         spin)
                for j, n in enumerate(order):
                    if n is not None:
                        names.setdefault(j, n)
                same = bool(np.array_equal(out, first))
                row = {"point": point, "spin": spin, "capture": i,
                       "age_s": time.perf_counter() - t_start,
                       "launches": len(order), "lost": lost,
                       "k2f_records": k2f,
                       "k2f_launches": counted["instance_norm"],
                       "output_equal_first": same}
                rows.append(row)
                print(json.dumps(row), flush=True)
                if not same:
                    bad.append(row)

    captures("fresh")
    cfg = get_preset("fastcut256")
    trainer = build_trainer(cfg, "cuda")
    state = trainer.init_state(cs.SEED)
    rng = np.random.default_rng(cs.SEED + 11)
    batch = tuple(rng.integers(0, 256, (cfg.data.batch_size,
                                        cfg.data.load_size,
                                        cfg.data.load_size, 3),
                               dtype=np.uint8) for _ in range(2))
    for _ in range(STEPS):
        state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    captures("steps")
    cs.profile_call(lambda: trainer.train_step(state, batch), "step",
                    calls=True)
    captures("profiled")
    del trainer, state
    torch.cuda.empty_cache()
    time.sleep(IDLE_S)
    captures("idle")
    with tempfile.TemporaryDirectory() as work:
        cs.phase_cut(work)
    captures("cut")
    torch.cuda.synchronize()
    left = {str(k): int(v.count_nonzero()) for k, v in norm._SYNC.items()}
    for r in rows:
        for x in r["lost"]:
            x["kernel"] = names.get(x["index"])
    summary = {"summary": True, "captures": len(rows),
               "with_lost_records": sum(bool(r["lost"]) for r in rows),
               "lost_by_point": {
                   f"{p} spin={s}": sum(len(r["lost"]) for r in rows
                                        if r["point"] == p
                                        and r["spin"] == s)
                   for p in ("fresh", "steps", "profiled", "idle", "cut")
                   for s in (False, True)},
               "lost_kernels": sorted({x["kernel"] or "?" for r in rows
                                       for x in r["lost"]}),
               "lost_indices": sorted({(x["index"], x["of"])
                                       for r in rows for x in r["lost"]}),
               "outputs_equal_first": not bad,
               "norm_fwd_counters_nonzero": left, "device": smi}
    print(json.dumps(summary), flush=True)
    K.reset_launch_counts()
    return 1 if bad or any(left.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
