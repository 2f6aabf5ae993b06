#!/usr/bin/env python3
"""Time ``python -m uig_torch.cli train`` of this checkout against another
checkout's (e.g. the parent: ``git archive HEAD~1 | tar -x -C DIR``) on one
card, in turns: other, this, this, other; then this checkout again with
the in-training FID on (``eval.fid_every=3``, 16 images).

    python3 tools/fit_ab.py DIR
    python3 tools/fit_ab.py --trace


Each run trains ``cyclegan256_dp`` as published (bf16, LPIPS on) for 6
steps in a process of its own, with ``chip_smoke.py``'s phase-fit data
and cadences (synthetic 286² data, batch 8, a log line every 2 steps, a
checkpoint every 3, a sample grid at 6). It reports the ms a step between
the log lines of steps 4 and 6, the one interval that no checkpoint, grid
or FID falls in, and the process's seconds; then the median of each side.
With ``--trace`` it runs this checkout's fit once, with the FID on and
``run.profile_steps=(4,6)``, and reads the Chrome trace that fit writes of
steps 5 and 6: the window's ms a step, the device's busy ms a step (the
union of its kernels), and each host thread's busy ms a step (the union of
its operator and CUDA runtime events), so a step that is slower than its
device time shows which thread holds it.
Card only; imports neither JAX nor the JAX package. Output: one JSON line
a run, then a summary line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = ["data.source=synthetic", "data.load_size=286",
             "data.batch_size=8", "run.log_every=2", "run.ckpt_every=3",
             "eval.sample_grid_every=6"]
FID = ["eval.fid_every=3", "eval.fid_num_samples=16"]
STEPS = 6


def _union_ms(spans: list) -> float:
    """ms covered by the union of (start, end) spans in µs."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def trace_summary(path: str, steps: int) -> dict:
    """Per step: the trace window, the device's busy time and each host
    thread's busy time, in ms."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    span = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    t0 = min(span(e)[0] for e in events)
    t1 = max(span(e)[1] for e in events)
    kernels = [span(e) for e in events if e.get("cat") == "kernel"]
    threads: dict = {}
    for e in events:
        if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver"):
            threads.setdefault(str(e["tid"]), []).append(span(e))
    busy = sorted(((t, _union_ms(v) / steps) for t, v in threads.items()),
                  key=lambda kv: -kv[1])
    return {"window_ms_per_step": (t1 - t0) / 1e3 / steps,
            "device_busy_ms_per_step": _union_ms(kernels) / steps,
            "device_kernels": len(kernels),
            "host_threads_busy_ms_per_step": dict(busy[:4])}


def run(checkout: str, extra=(), trace: bool = False) -> dict:
    with tempfile.TemporaryDirectory() as work:
        cmd = [sys.executable, "-m", "uig_torch.cli", "train", "--preset",
               "cyclegan256_dp", "--max-steps", str(STEPS)]
        for o in [*OVERRIDES, *extra, f"run.workdir={work}", "run.name=r"]:
            cmd += ["--set", o]
        env = dict(os.environ, PYTHONPATH=os.path.join(checkout, "src"))
        env.pop("CUBLAS_WORKSPACE_CONFIG", None)
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                           text=True, timeout=300)
        secs = time.perf_counter() - t0
        if r.returncode != 0:
            raise SystemExit(f"{checkout}: rc {r.returncode}: "
                             f"{r.stderr[-2000:]}")
        with open(os.path.join(work, "r", "metrics.jsonl")) as f:
            recs = {x["step"]: x for x in map(json.loads, f) if "fid" not in x}
        out = {}
        if trace:
            out["trace"] = trace_summary(
                os.path.join(work, "r", "profile", "steps_4_6.json"), 2)
    ms = 1e3 * (recs[6]["time"] - recs[4]["time"]) / 2
    return {"ms_step_4_to_6": ms, "process_seconds": secs, **out}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("fit_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if sys.argv[1] == "--trace":
        res = run(ROOT, [*FID, "run.profile_steps=(4,6)"], trace=True)
        print(json.dumps({"run": "this_fid_traced", **res,
                          "nvidia_smi": smi}))
        return 0
    other = os.path.abspath(sys.argv[1])
    order = [("other", other, ()), ("this", ROOT, ()), ("this", ROOT, ()),
             ("other", other, ()), ("this_fid", ROOT, FID),
             ("this_fid", ROOT, FID)]
    got = {}
    for name, checkout, extra in order:
        res = run(checkout, extra)
        got.setdefault(name, []).append(res["ms_step_4_to_6"])
        print(json.dumps({"run": name, **res}), flush=True)
    print(json.dumps({"median_ms": {k: float(np.median(v))
                                    for k, v in got.items()},
                      "runs_ms": got, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
