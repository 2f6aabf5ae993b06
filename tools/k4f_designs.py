"""Time K4f's bf16 forward (``src/uig_torch/csrc/conv7_tc.cu``) against the
four variants it was chosen over, on one card, at the generator head's
shapes in the training step, (16 | 8, 256, 256, 64) -> 3 with reflect
padding. The port's kernel has strips of up to 9 m16 tiles (one block an
SM), one tile a warp, one accumulator set and source rows loading one
ahead; the variants (``tools/k4f_designs.cu``) are rows loading two ahead,
and that one with one change each: two accumulator sets (the row taps ky
split by parity), strips of 4 tiles (two blocks an SM), two tiles a warp.

    python3 tools/k4f_designs.py

Builds ``tools/k4f_designs.cu``, which includes the port's ``conv7_tc.cu``,
with the port's nvcc flags into ``build/uig_torch/designs/`` and calls it
through ctypes; the port's kernel goes through ``conv7``. The variants'
template at the port's settings must give the port's output bit for bit.
Each variant is held against the plain version within 1 bf16 ulp of its
largest value and must repeat bit for bit; the variants of a case are then
timed in turns (A B ... B A) with ``chip_smoke.cuda_ms``, and one profiled
call of each gives its device ms. Prints the card's name and power limit,
then one JSON line a case; exits non-zero without a card, or if a variant
is out of tolerance or does not repeat.
"""

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SOURCE = ROOT / "tools" / "k4f_designs.cu"
ITERS = 20
# k4f_design_fwd's variant index: (most m16 tiles a strip, tiles a warp,
# accumulator sets, source rows loading ahead)
VARIANTS = {"template (9, 1, 1, 1)": 0, "two ahead (9, 1, 1, 2)": 1,
            "two accumulator sets (9, 1, 2, 2)": 2,
            "strips of 4 tiles (4, 1, 1, 2)": 3,
            "two tiles a warp (9, 2, 1, 2)": 4}


def build_designs() -> ctypes.CDLL:
    """The variants' library, built unless this source hash is built."""
    from uig_torch.kernels import _build

    flags = list(_build.NVCC_FLAGS)
    h = hashlib.sha256(" ".join(flags).encode())
    for p in (SOURCE, *sorted(_build.CSRC.glob("*.cu*"))):
        h.update(p.read_bytes())
    out = _build.BUILD_ROOT / "designs" / h.hexdigest()[:16]
    lib = out / "libk4f_designs.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build._nvcc(), *flags, "-shared", "-I",
                            str(_build.CSRC), str(SOURCE), "-o", str(lib)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{r.stdout}")
    dll = ctypes.CDLL(str(lib))
    fn = dll.k4f_design_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return dll


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k4f_designs: needs a CUDA device", file=sys.stderr)
        return 1
    from uig_torch.kernels import conv7, conv7_reference

    cs.emit({"phase": "env", "nvidia_smi": cs.nvidia_smi(),
             "nvcc": cs.nvcc_version(), "torch": torch.__version__})
    dll = build_designs()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)

    def randn(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    w, b = randn(7, 7, 64, 3, scale=0.02), randn(3, scale=0.02)
    ok = True
    for nb in (16, 8):
        x = randn(nb, 256, 256, 64)

        def variant(v, x=x):
            def run():
                y = torch.empty(*x.shape[:3], 3, device=dev,
                                dtype=torch.bfloat16)
                err = dll.k4f_design_fwd(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                    *x.shape, 1, v, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"k4f_design_fwd({v}): cudaError "
                                       f"{err}")
                return y
            return run

        fns = {"port": lambda x=x: conv7(x, w, b, "reflect")}
        fns.update({k: variant(v) for k, v in VARIANTS.items()})
        ref = conv7_reference(x, w, b, "reflect")
        ulp = cs.bf16_ulp(ref.float().abs().max().item())
        port = fns["port"]()
        lines = {}
        for label, fn in fns.items():
            got = fn()
            lines[label] = {"ulps": cs.max_err(got, ref) / ulp,
                            "repeat_bit_equal": torch.equal(got, fn()),
                            "ms": []}
            ok &= lines[label]["ulps"] <= 1.0
            ok &= lines[label]["repeat_bit_equal"]
        template_equal = torch.equal(fns["template (9, 1, 1, 1)"](), port)
        ok &= template_equal
        order = list(fns)
        for label in order + order[::-1]:
            lines[label]["ms"].append(cs.cuda_ms(fns[label], ITERS))
        for label, fn in fns.items():
            lines[label]["device_ms"] = cs.profile_call(
                fn, "designs")["device_busy_ms"]
        cs.emit({"phase": "k4f_designs", "case": f"({nb},256,256,64)->3",
                 "template_bit_equal_to_port": template_equal,
                 "variants": lines})
        del x, ref, port
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
