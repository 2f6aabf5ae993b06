"""Time K4s's bf16 wgmma forward and weight gradient with B (the weight, or
dy) loaded by TMA, as built, against B loaded by 16-byte ``cp.async``, on
one card at the generator's two downsample shapes at batch 16.

The second variant is built from a copy of ``src/uig_torch/csrc`` whose
``wgmma.cuh`` (the ring every wgmma kernel runs) routes every launch to the
cp.async loader in 16-byte pieces (valid where F % 8 == 0, as on these
shapes). Both variants run on
the same inputs, must give bit-equal outputs, and are timed in turns (TMA,
cp.async, cp.async, TMA; five rounds of 50 launches each). One JSON line a
shape, after the card's name and power limit.

    python3 tools/k4s_b_loader_ab.py
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the text of wgmma.cuh that the cp.async variant replaces
PATCHED = "wgmma.cuh"
PATCHES = [
    ("    load_b_cp_async<8, BN>(sb, b, row, row_end, N, n0, tid);",
     "    load_b_cp_async<16, BN>(sb, b, row, row_end, N, n0, tid);"),
    ("    return tma ? launch(va, std::true_type{}) : "
     "launch(va, std::false_type{});",
     "    return launch(va, std::false_type{});"),
]
SHAPES = ((256, 64, 128), (128, 128, 256))  # (H, Cin, Cout): d128, d256
BATCH, ROUNDS, ITERS = 16, 5, 50


def cp_async_library(tmp: Path) -> ctypes.CDLL:
    from uig_torch.kernels import _build

    shutil.copytree(_build.CSRC, tmp / "csrc")
    src = tmp / "csrc" / PATCHED
    text = src.read_text()
    for old, new in PATCHES:
        if old not in text:
            raise SystemExit(f"{PATCHED} no longer holds {old.strip()!r}")
        text = text.replace(old, new)
    src.write_text(text)
    csrc, root = _build.CSRC, _build.BUILD_ROOT
    _build.CSRC, _build.BUILD_ROOT = tmp / "csrc", tmp / "build"
    try:
        lib = ctypes.CDLL(str(_build.build()))
    finally:
        _build.CSRC, _build.BUILD_ROOT = csrc, root
    for name, argtypes in _build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.uig_error_string.argtypes = [ctypes.c_int]
    lib.uig_error_string.restype = ctypes.c_char_p
    return lib


def cuda_ms(fn) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(ITERS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / ITERS


def main() -> int:
    if not torch.cuda.is_available():
        print("k4s_b_loader_ab: no CUDA device", file=sys.stderr)
        return 1
    from uig_torch.kernels import _build
    from uig_torch.kernels.conv_s2 import conv3s2, conv3s2_wgrad

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    libs = {"tma": _build.library()}
    with tempfile.TemporaryDirectory() as tmp:
        libs["cp_async16"] = cp_async_library(Path(tmp))
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    same_all = True
    for h, cin, cout in SHAPES:
        x = torch.randn(BATCH, h, h, cin, generator=gen).to(dev, bf)
        w = (torch.randn(3, 3, cin, cout, generator=gen) * 0.05).to(dev, bf)
        b = (torch.randn(cout, generator=gen) * 0.05).to(dev, bf)
        dy = torch.randn(BATCH, h // 2, h // 2, cout,
                         generator=gen).to(dev, bf)
        ops = {"fwd": lambda: conv3s2(x, w, b),
               "wgrad": lambda: conv3s2_wgrad(x, dy)}
        outs, ms = {}, {k: {op: [] for op in ops} for k in libs}
        for k, lib in libs.items():
            _build._lib = lib
            outs[k] = [fn() for fn in ops.values()]
        same = all(torch.equal(u, v) for u, v in zip(*outs.values()))
        same_all &= same
        for _ in range(ROUNDS):
            for k in ("tma", "cp_async16", "cp_async16", "tma"):
                _build._lib = libs[k]
                for op, fn in ops.items():
                    ms[k][op].append(cuda_ms(fn))
        _build._lib = libs["tma"]
        print(json.dumps({
            "case": f"({BATCH},{h},{h},{cin})->{cout}", "bit_equal": same,
            "ms_median": {k: {op: float(np.median(v)) for op, v in d.items()}
                          for k, d in ms.items()},
            "ms": ms}), flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
