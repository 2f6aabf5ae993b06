"""K3's fp32 conv (``src/uig_torch/csrc/conv3_in_tf32.cu``) at several
depths of its partial sums: UIG_K3_DEPTH K stages of 32 channels summed in
the tensor core's fp32 accumulator before each rounded fp32 add to the
register sum (2, the kept depth: 64 channels; 8: one tap's 256 channels at
C = 256; 72: all of K = 9 x 256 in the accumulator). Each depth builds the
kernels with its own flag (its own directory under ``build/uig_torch/``) in
a worker process and runs the fused conv3+IN at the path's shapes, (8|16,
64, 64, 256) -> 256, reflect, with ReLU: its error against the plain
version (cuDNN fp32, TF32 off, + the plain norm) and against float64 on the
card beside the plain version's, whether a repeat is bit-equal, and ms a
launch by CUDA events. The depths run in turns (2, 8, 72, 72, 8, 2).

    python3 tools/k3_depths.py

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
DEPTHS = (2, 8, 72)


def worker(depth: int) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from uig_torch.kernels import _build, conv3_in_act, conv3_in_act_reference
    from uig_torch.serving import exact_fp32

    _build.NVCC_FLAGS.append(f"-DUIG_K3_DEPTH={depth}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def randn(*shape, scale=1.0, shift=0.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(dev)

    out = {"depth_stages": depth, "depth_channels": 32 * depth}
    w = randn(3, 3, 256, 256, scale=0.02)
    b, g, be = randn(256, scale=0.02), randn(256, scale=0.1, shift=1.0), \
        randn(256, scale=0.1)
    with exact_fp32():
        for nb in (8, 16):
            x = randn(nb, 64, 64, 256)
            y = conv3_in_act(x, w, b, g, be, relu=True)
            plain = conv3_in_act_reference(x, w, b, g, be, relu=True)
            errs = cs.fp64_errs(y, plain, cs.conv3_in_fp64(x, w, b, g, be,
                                                           True))
            out[f"batch{nb}"] = {
                "max_abs_err": cs.max_err(y, plain), **errs,
                "repeat_bit_equal": torch.equal(
                    y, conv3_in_act(x, w, b, g, be, relu=True)),
                "ms": cs.cuda_ms(lambda: conv3_in_act(x, w, b, g, be,
                                                      relu=True), ITERS)}
            del x, y, plain
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k3_depths: needs a CUDA device", file=sys.stderr)
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
        ok = ok and all(rec[k]["repeat_bit_equal"] for k in rec
                        if k.startswith("batch"))
        print(json.dumps({"turn": turn, **rec}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
