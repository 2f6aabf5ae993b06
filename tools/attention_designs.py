"""Time the attention kernels' designs against the alternatives they were
chosen over, on one card, at the VQGAN shapes (B, 1024, 512), B = 4 and 8,
fp32:

- K5f as the port builds it (64 q rows a block) with the keys in one range
  and in two, and with 32 q rows a block (``attention.cu`` built with
  ``UIG_ATTN_BQ=32``), one range and two;
- K5b as the port builds it (a scores kernel and three GEMMs over a P^T and
  dS^T scratch) and in FlashAttention-2's shape (``attention_designs.cu``:
  a dK/dV kernel with dS^T alone in the scratch, then the port's dQ GEMM).

    python3 tools/attention_designs.py

Builds ``tools/attention_designs.cu``, which includes the port's
``attention.cu``, with the port's nvcc flags into ``build/uig_torch/
designs/`` and calls it through ctypes; the port's own design goes through
``_build.launch``. Each variant's outputs are held against the plain
versions within ``chip_smoke.TOL`` (1e-5 of each output's largest value)
and must repeat bit for bit; the variants of a case are then timed in turns
(A B ... B A) with ``chip_smoke.cuda_ms``, and one profiled call of each
gives the device time by CUDA kernel. Prints the card's name and power
limit, the variant kernels' registers and spills, then one JSON line a
case; exits non-zero without a card or if a variant is out of tolerance.
"""

import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SOURCE = ROOT / "tools" / "attention_designs.cu"
ITERS = 20


def build_designs() -> tuple[ctypes.CDLL, str]:
    """The designs' library (built unless this source hash is built) and
    nvcc's log of this build ("" when cached)."""
    from uig_torch.kernels import _build

    flags = [*_build.NVCC_FLAGS, "-DUIG_ATTN_BQ=32"]
    h = hashlib.sha256(" ".join(flags).encode())
    for p in (SOURCE, _build.CSRC / "attention.cu"):
        h.update(p.read_bytes())
    out = _build.BUILD_ROOT / "designs" / h.hexdigest()[:16]
    lib, log = out / "libattention_designs.so", ""
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build._nvcc(), *flags, "-shared", "-I",
                            str(_build.CSRC), str(SOURCE), "-o", str(lib)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        log = r.stdout
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{log}")
    dll = ctypes.CDLL(str(lib))
    fwd = getattr(dll, "uig_attention_fwd")
    fwd.argtypes = _build.SIGNATURES["uig_attention_fwd"]
    fwd.restype = ctypes.c_int
    # uig_attention_bwd's arguments without is_bf16 (fp32 only)
    dkdv = getattr(dll, "uig_attention_bwd_dkdv")
    dkdv.argtypes = (_build.SIGNATURES["uig_attention_bwd"][:-2]
                     + [ctypes.c_void_p])
    dkdv.restype = ctypes.c_int
    return dll, log


def call(dll: ctypes.CDLL, name: str, *args) -> None:
    """C entry point ``name`` of the designs' library on the current
    stream; tensors pass as device pointers."""
    import torch

    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(dll, name)(*conv, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {err}")


def device_ms(fn) -> dict:
    """{CUDA function: device ms} over one profiled call."""
    out: dict = {}
    for e in cs.profile_call(fn, "designs")["top"]:
        m = re.search(r"(\w+)[<(]", e["kernel"])
        name = m.group(1) if m else e["kernel"]
        out[name] = out.get(name, 0.0) + e["ms"]
    return out


def compare(variants: dict, refs: tuple, tol: float) -> tuple[dict, bool]:
    """Check, repeat and time each variant (in turns), profile it once."""
    import torch

    lines, ok = {}, True
    for label, fn in variants.items():
        got = cs._outputs(fn())
        _, rel, _ = cs._multi_rel_check(got, refs)
        again = cs._outputs(fn())
        lines[label] = {"rel_err": rel, "ok": rel <= tol,
                        "repeat_bit_equal": all(
                            torch.equal(u, w) for u, w in zip(got, again)),
                        "ms": []}
        ok &= rel <= tol and lines[label]["repeat_bit_equal"]
    order = list(variants)
    for label in order + order[::-1]:
        lines[label]["ms"].append(cs.cuda_ms(variants[label], ITERS, 2))
    for label, fn in variants.items():
        lines[label]["device_ms"] = device_ms(fn)
    return lines, ok


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_designs: no CUDA device", file=sys.stderr)
        return 1
    from uig_torch.kernels import _build
    from uig_torch.kernels.attention import (_key_splits, _scale,
                                             attention_bwd,
                                             attention_bwd_reference,
                                             attention_fwd,
                                             attention_reference)
    from uig_torch.serving import exact_fp32

    cs.emit({"phase": "env", "nvidia_smi": cs.nvidia_smi(),
             "nvcc": cs.nvcc_version(), "torch": torch.__version__})
    _build.library()
    dll, log = build_designs()
    cs.emit({"phase": "ptxas", "kernels": cs.wgmma_ptxas([log], "attn_")})
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(cs.SEED)
    ok = True
    with exact_fp32():
        for nb in (4, 8):
            n, d = 1024, 512
            q, k, v, do = (torch.randn(nb, n, d, generator=g).to(dev)
                           for _ in range(4))

            def fwd(launch, splits, q=q, k=k, v=v, nb=nb):
                def run():
                    o = torch.empty_like(q)
                    lse = torch.empty(nb, n, device=dev)
                    part = (torch.empty(2 * nb * n * (d + 1), device=dev)
                            if splits == 2 else None)
                    launch("uig_attention_fwd", q, k, v, o, lse, part, None,
                           nb, n, d, _scale(d), splits, False)
                    return o
                return run

            def alt(name, *args):
                call(dll, name, *args)

            lines, good = compare(
                {"64 rows, 1 range": fwd(_build.launch, 1),
                 "64 rows, 2 ranges": fwd(_build.launch, 2),
                 "32 rows, 1 range": fwd(alt, 1),
                 "32 rows, 2 ranges": fwd(alt, 2)},
                (attention_reference(q, k, v),), cs.TOL["attention_fwd"])
            ok &= good
            bms, _ = cs.bound_ms(4.0 * (4 * q.numel() + nb * n),
                                 4.0 * nb * n * n * d, design="tf32x3")
            cs.emit({"phase": "attention_fwd", "case": f"({nb},{n},{d})",
                     "port_ranges": _key_splits(dev, nb, n),
                     "bound_ms": bms, "variants": lines})

            o, lse, _ = attention_fwd(q, k, v)

            def dkdv(q=q, k=k, v=v, o=o, lse=lse, do=do, nb=nb):
                grads = tuple(torch.empty_like(q) for _ in range(3))
                n_pad = -(-n // 128) * 128
                delta = torch.empty(nb, n, device=dev)
                ds = torch.empty(nb, n_pad, n_pad, device=dev)
                call(dll, "uig_attention_bwd_dkdv", q, k, v, o, lse, do,
                     delta, ds, *grads, nb, n, d, _scale(d))
                return grads

            lines, good = compare(
                {"scores + dV, dK, dQ GEMMs (port)":
                     lambda q=q, k=k, v=v, o=o, lse=lse, do=do:
                     attention_bwd(q, k, v, o, lse, do),
                 "dK/dV kernel + dQ GEMM": dkdv},
                attention_bwd_reference(q, k, v, do), cs.TOL["attention_bwd"])
            ok &= good
            bms, _ = cs.bound_ms(4.0 * (8 * q.numel() + nb * n),
                                 10.0 * nb * n * n * d, design="tf32x3")
            cs.emit({"phase": "attention_bwd", "case": f"({nb},{n},{d})",
                     "bound_ms": bms, "variants": lines})
            del q, k, v, do, o, lse
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
