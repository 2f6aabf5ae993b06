"""Hold this checkout against another one (for example the parent commit,
unpacked with ``git archive``) on one card: the fp32 outputs of K3, K4s's
dgrad and K4d (the 7x7 head's dgrad, at both step batches) and K1's fp32
and bf16 outputs at the training step's shapes must be bit-identical, and
the
``cyclegan256_dp`` training step is timed in fp32 and in bf16 in turns
(this, other, other, this), each checkout in its own process with its own
build.

    python3 tools/ab_checkouts.py OTHER_CHECKOUT

One JSON line a run, then one with the verdict, after the card's name and
power limit; exits non-zero if an output differs. The bf16 step runs with
LPIPS off, which a checkout from before LPIPS was ported needs.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED, BATCH, WARMUP, TIMED = 0, 8, 3, 10
OVERRIDES = {"float32": ["model.compute_dtype=float32", "loss.lambda_lpips=0"],
             "bfloat16": ["loss.lambda_lpips=0"]}


def worker(out: Path) -> None:
    """In the checkout whose ``src`` is on sys.path: save the fp32 outputs
    and print the step times."""
    import numpy as np
    import torch

    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.kernels import (augment_batch, conv3_in_act,
                                   conv3s2_dgrad, conv7_dgrad)
    from uig_torch.serving import exact_fp32
    from uig_torch.train import CycleGANTrainer

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def randn(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    outs = {}
    with exact_fp32():
        x, w = randn(BATCH, 64, 64, 256), randn(3, 3, 256, 256, scale=0.02)
        b, g, be = randn(256, scale=0.02), randn(256, scale=0.1) + 1, \
            randn(256, scale=0.1)
        for relu in (True, False):
            outs[f"conv3_in_act relu={relu}"] = conv3_in_act(
                x, w, b, g, be, relu=relu).cpu()
        for h, cin, cout in ((256, 64, 128), (128, 128, 256)):
            dy = randn(BATCH, h // 2, h // 2, cout)
            wd = randn(3, 3, cin, cout, scale=0.05)
            outs[f"conv3s2_dgrad {h} {cin}->{cout}"] = conv3s2_dgrad(dy,
                                                                     wd).cpu()
        w7 = randn(7, 7, 64, 3, scale=0.02)
        for nb in (2 * BATCH, BATCH):
            outs[f"conv7_dgrad {nb} reflect"] = conv7_dgrad(
                randn(nb, 256, 256, 3), w7, "reflect").cpu()
    u8 = torch.from_numpy(rng.integers(0, 256, (BATCH, 286, 286, 3),
                                       dtype=np.uint8)).to(dev)
    oy, ox = (torch.from_numpy(rng.integers(0, 31, BATCH)) for _ in range(2))
    flip = torch.from_numpy(np.arange(BATCH) % 2 == 0)
    for dt in (torch.float32, torch.bfloat16):
        outs[f"augment_batch {dt}"] = augment_batch(u8, oy, ox, flip, 256,
                                                    dt).cpu()
    torch.save(outs, out)

    times = {}
    load = 286
    a_u8, b_u8 = (rng.integers(0, 256, (BATCH, load, load, 3),
                               dtype=np.uint8) for _ in range(2))
    torch.use_deterministic_algorithms(True)
    for dtype, overrides in OVERRIDES.items():
        cfg = apply_overrides(get_preset("cyclegan256_dp"), overrides)
        tr = CycleGANTrainer(cfg)
        st = tr.init_state(SEED)
        ms = []
        for i in range(WARMUP + TIMED):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            st, _ = tr.train_step(st, (a_u8, b_u8))
            e1.record()
            torch.cuda.synchronize()
            if i >= WARMUP:
                ms.append(e0.elapsed_time(e1))
        times[dtype] = {"step_ms_median": float(np.median(ms)),
                        "step_ms": ms}
        del tr, st
        torch.cuda.empty_cache()
    print(json.dumps(times), flush=True)


def run(checkout: Path, out: Path) -> dict:
    # cuBLAS runs deterministically only with a fixed workspace
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--worker", str(out)], cwd=str(checkout), env=env,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise SystemExit(f"worker in {checkout} failed:\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker))
        return 0
    import torch

    if not torch.cuda.is_available() or args.other is None:
        print("ab_checkouts: needs a CUDA device and another checkout",
              file=sys.stderr)
        return 1
    other = Path(args.other).resolve()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    names = {"this": ROOT, "other": other}
    outputs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, who in enumerate(("this", "other", "other", "this")):
            out = Path(tmp) / f"{turn}_{who}.pt"
            times = run(names[who], out)
            outputs.setdefault(who, torch.load(out))
            print(json.dumps({"turn": turn, "checkout": who,
                              **{k: v["step_ms_median"]
                                 for k, v in times.items()},
                              "step_ms": {k: v["step_ms"]
                                          for k, v in times.items()}}),
                  flush=True)
    same = {k: torch.equal(v, outputs["other"][k])
            for k, v in outputs["this"].items()}
    print(json.dumps({"bit_identical": same}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
