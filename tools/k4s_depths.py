"""K4s's fp32 forward, input and weight gradients
(``src/uig_torch/csrc/conv3s2_tf32.cu``) at four depths of their partial
sums: the K stages summed in the tensor core's fp32 accumulator before each
rounded fp32 add to the register sum. The forward's stages are 32 channels
of one tap of C (UIG_K4S_FWD_DEPTH: 1, 2, 8: 32, 64, 256 channels; 1 << 20:
all of K, 576 or 1152 channels); the dgrad's are 32 channels of F
(UIG_K4S_DGRAD_DEPTH: 1, 2, 8: 32, 64, 256 channels; 32: 1024, all of K of
the d256 class with four taps); the wgrad's are 32 pixels
(UIG_K4S_WGRAD_DEPTH: 1, 2, 8: 32, 64, 256 pixels; 1 << 20: a block's
whole chunk, ~4,700-5,100 pixels at batch 16). The kept depths, the
source's defaults: 2 (forward), 1 (dgrad) and 2 (wgrad). Each depth builds
the kernels with its own flags (its own directory under
``build/uig_torch/``) in a worker process and runs the forward and both
gradients of the downsamples d128 (256^2, 64 -> 128) and d256 (128^2, 128
-> 256) at batch 8 and 16: the error against the plain version (cuDNN
fp32, TF32 off) and against float64 on the card beside the plain
version's, each relative to the output's largest value, whether a repeat
is bit-equal, and ms a launch by CUDA events. The depths run in turns (1,
2, 8, all, all, 8, 2, 1).

    python3 tools/k4s_depths.py

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
# (forward stages, dgrad stages, wgrad stages) a partial
DEPTHS = ((1, 1, 1), (2, 2, 2), (8, 8, 8), (1 << 20, 32, 1 << 20))
SHAPES = {"d128": (256, 64, 128), "d256": (128, 128, 256)}


def worker(fwd_depth: int, dgrad_depth: int, wgrad_depth: int) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from uig_torch.kernels import (_build, conv3s2, conv3s2_dgrad,
                                   conv3s2_dgrad_reference, conv3s2_reference,
                                   conv3s2_wgrad, conv3s2_wgrad_reference)
    from uig_torch.serving import exact_fp32

    _build.NVCC_FLAGS += [f"-DUIG_K4S_FWD_DEPTH={fwd_depth}",
                          f"-DUIG_K4S_DGRAD_DEPTH={dgrad_depth}",
                          f"-DUIG_K4S_WGRAD_DEPTH={wgrad_depth}"]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def randn(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    out = {"fwd_depth_channels": 32 * fwd_depth,
           "dgrad_depth_channels": 32 * dgrad_depth,
           "wgrad_depth_pixels": 32 * wgrad_depth}
    with exact_fp32():
        for nb in (8, 16):
            for key, (h, cin, cout) in SHAPES.items():
                x = randn(nb, h, h, cin)
                w = randn(3, 3, cin, cout, scale=0.05)
                b = randn(cout, scale=0.05)
                dy = randn(nb, h // 2, h // 2, cout)
                rec = {}
                for name, fn, plain, exact in (
                        ("fwd", lambda: conv3s2(x, w, b),
                         lambda: conv3s2_reference(x, w, b),
                         lambda: cs.conv_fwd_fp64(x, w, b, 2, 1)),
                        ("dgrad", lambda: conv3s2_dgrad(dy, w),
                         lambda: conv3s2_dgrad_reference(dy, w),
                         lambda: cs.conv_dgrad_fp64(dy, w, (h, h), 2, 1)),
                        ("wgrad", lambda: conv3s2_wgrad(x, dy),
                         lambda: conv3s2_wgrad_reference(x, dy),
                         lambda: cs.conv_wgrad_fp64(x, dy, 3, 2, 1))):
                    got, ref = fn(), plain()
                    rec[name] = {
                        "rel_err": cs.max_err(got, ref)
                        / ref.abs().max().item(),
                        **cs.fp64_errs(got, ref, exact()),
                        "repeat_bit_equal": torch.equal(got, fn()),
                        "ms": cs.cuda_ms(fn, ITERS)}
                    del got, ref
                out[f"batch{nb} {key}"] = rec
                del x, w, b, dy
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, nargs=3)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k4s_depths: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    ok = True
    for turn, (fd, dd, wd) in enumerate(DEPTHS + DEPTHS[::-1]):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--worker", str(fd), str(dd), str(wd)],
                           cwd=str(ROOT),
                           env=env, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise SystemExit(f"depths {fd}, {dd}, {wd} failed:\n"
                             f"{r.stderr[-4000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        ok = ok and all(v["repeat_bit_equal"] for k, c in rec.items()
                        if k.startswith("batch") for v in c.values())
        print(json.dumps({"turn": turn, **rec}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
