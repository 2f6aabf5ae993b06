"""K4d's and K4w's fp32 kernels (``src/uig_torch/csrc/conv7_bwd_tf32.cu``,
``src/uig_torch/csrc/conv7_wgrad_tf32.cu``) at two depths of their partial
sums (the products summed in the tensor core's fp32 accumulator before each
rounded fp32 add to the register sum):

- "default": the sources' depths (K4d one k8 step a partial, K4w a strip
  row's k8 steps, 64 padded columns);
- "other": K4d three k8 steps (24 k, about one window row), K4w one k8
  step.

Each variant builds the kernels with its own ``-DUIG_K4D_DEPTH`` /
``-DUIG_K4W_DEPTH`` (its own directory under ``build/uig_torch/``) in a
worker process and runs both at the training step's shapes, (16 | 8, 256,
256, 64) <-> 3 with reflect padding and (8, 256, 256, 64) <-> 3 with zeros:
the error against the plain version (cuDNN fp32, TF32 off) relative to the
output's largest value, the error against float64 on the card beside the
plain version's, whether a repeat is bit-equal, and ms a launch by CUDA
events. The variants run in turns (default, other, other, default).

    python3 tools/k4d_k4w_depths.py

One JSON line a run after the card's name and power limit; exits non-zero
if a repeat differs.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED, ITERS = 0, 20
VARIANTS = {"default": [],
            "other": ["-DUIG_K4D_DEPTH=3", "-DUIG_K4W_DEPTH=1"]}
CASES = ((16, "reflect"), (8, "reflect"), (8, "zeros"))


def worker(variant: str) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from uig_torch.kernels import (_build, conv7_dgrad, conv7_dgrad_reference,
                                   conv7_wgrad, conv7_wgrad_reference)
    from uig_torch.serving import exact_fp32

    _build.NVCC_FLAGS += VARIANTS[variant]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def randn(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    def measure(fn, ref, exact):
        got = fn()
        return {"rel_err": cs.max_err(got, ref) / ref.abs().max().item(),
                **cs.fp64_errs(got, ref, exact),
                "repeat_bit_equal": torch.equal(got, fn()),
                "ms": cs.cuda_ms(fn, ITERS)}

    out = {"variant": variant}
    w = randn(7, 7, 64, 3, scale=0.02)
    with exact_fp32():
        for nb, mode in CASES:
            x, dy = randn(nb, 256, 256, 64), randn(nb, 256, 256, 3)
            out[f"dgrad batch{nb} {mode}"] = measure(
                lambda: conv7_dgrad(dy, w, mode),
                conv7_dgrad_reference(dy, w, mode),
                cs.conv7_dgrad_fp64(dy, w, mode))
            out[f"wgrad batch{nb} {mode}"] = measure(
                lambda: conv7_wgrad(x, dy, mode),
                conv7_wgrad_reference(x, dy, mode),
                cs.conv7_wgrad_fp64(x, dy, mode))
            del x, dy
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k4d_k4w_depths: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    order = list(VARIANTS)
    ok = True
    for turn, variant in enumerate(order + order[::-1]):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--worker", variant], cwd=str(ROOT), env=env,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise SystemExit(f"{variant} failed:\n{r.stderr[-4000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        ok = ok and all(c["repeat_bit_equal"] for k, c in rec.items()
                        if k != "variant")
        print(json.dumps({"turn": turn, **rec}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
