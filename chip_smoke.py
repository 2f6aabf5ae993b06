#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. env: the card's name and power limit (nvidia-smi), torch/CUDA versions,
   and the time to build the CUDA kernels from ``src/uig_torch/csrc``.
2. kernels: each CUDA kernel at the shapes the generator gives it, held
   against its plain PyTorch version on the card (fp32, TF32 off) within a
   stated tolerance, and timed with CUDA events beside the plain version,
   one PyTorch library call computing the same function (a yardstick the
   port never calls), and the least time the card could take (bound).
3. slice: a ``Translator`` for ``cyclegan256_dp`` at full width, weights in
   the flax layout made from a seed with numpy and carried through
   ``uig_torch.convert``. A seeded uint8 batch (8, 286, 286, 3) goes through
   twice and must come out byte-identical; two images through the same model
   on the CPU (plain versions) must agree within 1 uint8 step; each apply
   must launch instance norm 5 times, conv3+IN 18 times, conv7 once.
4. serve: the HTTP server on the card answers 12 concurrent PNG requests,
   each equal to a direct ``Translator`` call, and reports its /stats.

Then one ``kernels`` line (every kernel with its launches in one apply of
the main path, its error, times and bound), the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PRESET = "cyclegan256_dp"
BATCH = 8
SEED = 0
# H100 SXM data-sheet peaks (at 700 W): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# max |kernel - plain| on the card: fp32 sums in another order. Normalized
# outputs are O(1); the conv sums run over up to 9*256 and 49*64 terms.
TOL = {"instance_norm": 1e-4, "conv3_in_act": 2e-4, "conv7": 1e-4}
REPLACES = {
    "instance_norm": "src/uig/kernels/norm_pallas.py:127",
    "conv3_in_act": "src/uig/kernels/convin_pallas.py:141",
    "conv7": "src/uig/kernels/conv_pallas.py:209",
}
SOURCES = {
    "instance_norm": "src/uig_torch/csrc/instance_norm.cu",
    "conv3_in_act": "src/uig_torch/csrc/conv3_in.cu",
    "conv7": "src/uig_torch/csrc/conv7.cu",
}
PER_APPLY = {"instance_norm": 5, "conv3_in_act": 18, "conv7": 1}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def max_err(a, b) -> float:
    d = (a.double() - b.double()).abs().max().item()
    if d != d:
        raise AssertionError("NaN in kernel output")
    return d


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def kernel_cases(dev):
    """Yield (kernel name, case label, calls per apply, kernel fn, plain fn,
    library fn, bytes, flops) at the shapes the generator gives each kernel."""
    import torch
    import torch.nn.functional as F

    from uig_torch.kernels import (conv3_in_act, conv3_in_act_reference,
                                   conv7, conv7_reference, instance_norm,
                                   instance_norm_reference)

    g = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(dev)

    # instance norm: the stem/down/up norms, each followed by a fused ReLU
    for (h, c), calls in (((256, 64), 2), ((128, 128), 2), ((64, 256), 1)):
        x = randn(BATCH, h, h, c, scale=2.0, shift=0.5)
        ga, be = randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1)
        n = x.numel()
        yield ("instance_norm", f"({BATCH},{h},{h},{c}) relu", calls,
               lambda x=x, ga=ga, be=be: instance_norm(x, ga, be, relu=True),
               lambda x=x, ga=ga, be=be: instance_norm_reference(
                   x, ga, be, relu=True),
               lambda x=x, ga=ga, be=be: F.instance_norm(
                   x.permute(0, 3, 1, 2), weight=ga, bias=be, eps=1e-5),
               8.0 * n, 6.0 * n)
    # conv3 + IN: the 18 trunk pairs, half with ReLU
    h, c = 64, 256
    x = randn(BATCH, h, h, c)
    w = randn(3, 3, c, c, scale=0.02)
    b, ga, be = randn(c, scale=0.02), randn(c, scale=0.1, shift=1.0), \
        randn(c, scale=0.1)
    flops = 2.0 * BATCH * h * h * c * 9 * c
    nbytes = 4.0 * (2 * x.numel() + w.numel() + 3 * c)
    for relu, calls in ((True, 9), (False, 9)):
        yield ("conv3_in_act", f"({BATCH},{h},{h},{c})->{c} reflect relu={relu}",
               calls,
               lambda relu=relu: conv3_in_act(x, w, b, ga, be, relu=relu),
               lambda relu=relu: conv3_in_act_reference(x, w, b, ga, be,
                                                        relu=relu),
               lambda: F.instance_norm(F.conv2d(
                   F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
                   w.permute(3, 2, 0, 1), b), weight=ga, bias=be, eps=1e-5),
               nbytes, flops)
    # conv7: the head, plus zeros padding at a smaller shape (not on the path)
    for (nb, h, mode), calls in (((BATCH, 256, "reflect"), 1),
                                 ((2, 64, "zeros"), 0)):
        x = randn(nb, h, h, 64)
        w = randn(7, 7, 64, 3, scale=0.02)
        b = randn(3, scale=0.02)
        pad = ((lambda t: F.pad(t, (3, 3, 3, 3), mode="reflect"))
               if mode == "reflect" else
               (lambda t: F.pad(t, (3, 3, 3, 3))))
        yield ("conv7", f"({nb},{h},{h},64)->3 {mode}", calls,
               lambda x=x, w=w, b=b, mode=mode: conv7(x, w, b, mode),
               lambda x=x, w=w, b=b, mode=mode: conv7_reference(x, w, b, mode),
               lambda x=x, w=w, b=b, pad=pad: F.conv2d(
                   pad(x.permute(0, 3, 1, 2)), w.permute(3, 2, 0, 1), b),
               4.0 * (x.numel() + w.numel() + 3 + nb * h * h * 3),
               2.0 * nb * h * h * 3 * 49 * 64)


def phase_kernels(dev) -> dict:
    from uig_torch.serving import exact_fp32

    totals = {}
    with exact_fp32():
        for name, label, calls, fn, plain, lib, nbytes, flops in \
                kernel_cases(dev):
            err = max_err(fn(), plain())
            if err > TOL[name]:
                raise AssertionError(
                    f"{name} {label}: max|err| {err} > tol {TOL[name]}")
            ms, plain_ms, lib_ms = cuda_ms(fn), cuda_ms(plain), cuda_ms(lib)
            bms, by = bound_ms(nbytes, flops)
            emit({"phase": "kernel", "name": name, "case": label,
                  "calls_per_apply": calls, "max_abs_err": err,
                  "tol": TOL[name], "ms": ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": bms, "bound_by": by})
            t = totals.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                         "plain_ms": 0.0, "library_ms": 0.0,
                                         "bound_ms": 0.0, "bound_by": by})
            t["max_abs_err"] = max(t["max_abs_err"], err)
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bms)):
                t[k] += calls * v
    return totals


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------


def seeded_flax_weights(path: str) -> None:
    """Flax-layout flat weights for the full-width preset, from a seed:
    normal(0.02) kernels and biases, instance norm scale 1 + 0.1 N and
    bias 0.1 N."""
    from uig_torch.config import get_preset
    from uig_torch.convert import flax_from_generator_state
    from uig_torch.models import generator_from_config

    shapes = flax_from_generator_state(
        generator_from_config(get_preset(PRESET).model).state_dict())
    rng = np.random.default_rng(SEED)
    flat = {}
    for key, ref in shapes.items():
        if key.endswith("/scale"):
            v = 1.0 + 0.1 * rng.standard_normal(ref.shape)
        elif key.endswith("/bias") and key[:-5] + "/scale" in shapes:
            v = 0.1 * rng.standard_normal(ref.shape)
        else:
            v = 0.02 * rng.standard_normal(ref.shape)
        flat[key] = v.astype(np.float32)
    np.savez(path, **flat)


def phase_slice(weights: str):
    import torch

    from uig_torch import kernels as K
    from uig_torch.serving import Translator

    t0 = time.perf_counter()
    tr = Translator(PRESET, weights, batch_size=BATCH)
    load = tr.load
    rng = np.random.default_rng(SEED + 1)
    raw = rng.integers(0, 256, (BATCH, load, load, 3), dtype=np.uint8)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    K.reset_launch_counts()
    out1 = tr(raw)  # the main path's run
    launches = K.launch_counts()
    if launches != PER_APPLY:
        raise AssertionError(f"launches per apply {launches} != {PER_APPLY}")
    K.reset_launch_counts()
    out2 = tr(raw)
    if K.launch_counts() != PER_APPLY:
        raise AssertionError(f"second apply launched {K.launch_counts()}")
    if out1.shape != (BATCH, tr.crop, tr.crop, 3) or out1.dtype != np.uint8:
        raise AssertionError(f"output {out1.dtype} {out1.shape}")
    if not np.array_equal(out1, out2):
        raise AssertionError("two runs on the same batch differ")
    spread = int(out1.max()) - int(out1.min())
    if spread < 64:
        raise AssertionError(f"output nearly constant (spread {spread})")

    t1 = time.perf_counter()
    cpu = Translator(PRESET, weights, batch_size=2, device="cpu")
    ref = cpu(raw[:2])
    cpu_s = time.perf_counter() - t1
    cpu_diff = int(np.abs(ref.astype(np.int16) - out1[:2]).max())
    if cpu_diff > 1:
        raise AssertionError(f"card vs CPU plain: {cpu_diff} uint8 steps")
    n_off = int((ref != out1[:2]).sum())

    iters = 10
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(iters):
        tr(raw)
    wall = (time.perf_counter() - t2) / iters
    x = torch.from_numpy(raw).to(tr.device)
    from uig_torch.kernels.augment import center_crop_normalize
    xf = center_crop_normalize(x, tr.crop)
    torch.cuda.reset_peak_memory_stats()
    gen_ms = cuda_ms(lambda: tr.translate_float(xf), iters=iters, warmup=2)
    emit({"phase": "slice", "preset": PRESET, "batch": BATCH,
          "output": list(out1.shape), "byte_identical_repeat": True,
          "cpu_plain_max_step": cpu_diff, "cpu_plain_pixels_off": n_off,
          "cpu_plain_seconds": cpu_s, "setup_seconds": build_s,
          "launches_per_apply": launches,
          "translate_ms_per_batch": 1e3 * wall,
          "img_per_s": BATCH / wall,
          "generator_ms_per_batch": gen_ms,
          "generator_img_per_s": 1e3 * BATCH / gen_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    emit(profile_translate(tr, raw))
    return tr, launches


def profile_translate(tr, raw) -> dict:
    """Device time by kernel name over one translate call (torch.profiler),
    and the share of the call's wall time that the card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr(raw)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"phase": "profile", "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if by_name else "not measured",
            "device_busy_share": busy_ms / wall_ms if by_name else "not measured",
            "top": [{"kernel": k[:70], "calls": n, "ms": us / 1e3}
                    for k, (n, us) in top]}


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------


def _post(port: int, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/translate", body=body,
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_serve(tr, weights: str) -> None:
    from PIL import Image

    from uig_torch.serve import start_server

    rng = np.random.default_rng(SEED + 2)
    imgs = rng.integers(0, 256, (12, tr.load, tr.load, 3), dtype=np.uint8)
    handle = start_server(PRESET, weights, batch_size=BATCH, port=0,
                          max_delay_ms=20.0)
    try:
        results = [None] * len(imgs)

        def worker(i):
            buf = io.BytesIO()
            Image.fromarray(imgs[i]).save(buf, format="PNG")
            results[i] = _post(handle.port, buf.getvalue())

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                raise AssertionError("a request did not return")
        for i, (status, body) in enumerate(results):
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status} {body[:200]}")
            got = np.asarray(Image.open(io.BytesIO(body)))
            want = tr(imgs[i:i + 1])[0]
            if got.shape != (tr.crop, tr.crop, 3) or not np.array_equal(got, want):
                raise AssertionError(f"request {i}: differs from Translator")
        conn = http.client.HTTPConnection("127.0.0.1", handle.port, timeout=30)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        handle.close()
    emit({"phase": "serve", "requests_ok": len(imgs), "stats": stats})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "uig_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/uig_torch/ not found)", file=sys.stderr)
        return 1
    from uig_torch.kernels import _build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in open(_build.build_info["log"])
             if "registers" in ln or "spill" in ln] \
        if "log" in _build.build_info else []
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_seconds": build_s, "build_cached": _build.build_info["cached"],
          "ptxas": ptxas[:12]})
    dev = torch.device("cuda", 0)
    totals = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "g_a2b.npz")
        seeded_flax_weights(weights)
        tr, launches = phase_slice(weights)
        phase_serve(tr, weights)
    kernels = []
    for name in ("instance_norm", "conv3_in_act", "conv7"):
        t = totals[name]
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        "per": "one generator apply at batch 8"})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
