"""K4f's fp32 forward (``src/uig_torch/csrc/conv7_tf32.cu``) at two depths
of its partial sums: the products summed in the tensor core's fp32
accumulator before each rounded fp32 add to the output's register sum.
UIG_K4F_DEPTH=1 (the source's default): one k8 step, the 8 channels of one
row tap, each partial started fresh; 0: all of a Z value's 7 Cin products
in the accumulator (448 at Cin 64). Each depth builds the kernels with its
own flags (its own directory under ``build/uig_torch/``) in a worker
process and runs the head at the training step's shapes, (16 | 8, 256, 256,
64) -> 3 with reflect padding and (8, 256, 256, 64) -> 3 with zeros: the
error against the plain version (cuDNN fp32, TF32 off) and against float64
on the card beside the plain version's, each relative to the output's
largest value, whether a repeat is bit-equal, and ms a launch by CUDA
events. The depths run in turns (1, 0, 0, 1).

    python3 tools/k4f_depths.py

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
DEPTHS = (1, 0)
CASES = ((16, "reflect"), (8, "reflect"), (8, "zeros"))


def worker(depth: int) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from uig_torch.kernels import _build, conv7, conv7_reference
    from uig_torch.serving import exact_fp32

    _build.NVCC_FLAGS += [f"-DUIG_K4F_DEPTH={depth}"]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def randn(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    out = {"depth_k8_steps": depth or "all"}
    w, b = randn(7, 7, 64, 3, scale=0.02), randn(3, scale=0.02)
    with exact_fp32():
        for nb, mode in CASES:
            x = randn(nb, 256, 256, 64)
            fn = lambda: conv7(x, w, b, mode)  # noqa: E731
            got, ref = fn(), conv7_reference(x, w, b, mode)
            out[f"batch{nb} {mode}"] = {
                "rel_err": cs.max_err(got, ref) / ref.abs().max().item(),
                **cs.fp64_errs(got, ref, cs.conv7_fp64(x, w, b, mode)),
                "repeat_bit_equal": torch.equal(got, fn()),
                "ms": cs.cuda_ms(fn, ITERS)}
            del x, got, ref
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k4f_depths: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    ok = True
    for turn, depth in enumerate(DEPTHS + DEPTHS[::-1]):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--worker", str(depth)], cwd=str(ROOT), env=env,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise SystemExit(f"depth {depth} failed:\n{r.stderr[-4000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        ok = ok and all(c["repeat_bit_equal"] for k, c in rec.items()
                        if k.startswith("batch"))
        print(json.dumps({"turn": turn, **rec}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
