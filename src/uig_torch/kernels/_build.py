"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one
``libuig_torch_kernels.so`` with a plain C interface, loaded with ``ctypes``.
The build runs at first use into ``build/uig_torch/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and flags, so a fresh checkout
builds everything on its first kernel call and later calls reuse the library.

Each C entry point takes raw device pointers, sizes and the CUDA stream, and
returns a ``cudaError_t``; :func:`launch` raises if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "uig_torch"
LIB_NAME = "libuig_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every entry point ends with the stream and returns
# cudaError_t; the int before the stream is is_bf16 (the storage type).
SIGNATURES = {
    "uig_instance_norm_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                              _I, _P],
    "uig_conv3_in_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _F, _I, _P],
    "uig_conv7_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "uig_augment": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "uig_instance_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _P],
    "uig_conv7_dgrad": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "uig_conv7_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "uig_conv_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P],
    "uig_conv_dgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P],
    "uig_conv_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _P],
    "uig_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I,
                          _P],
    "uig_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels unless this source hash is already built; return
    the library's path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.update(cached=True)
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    build_info.update(cached=False, log=str(out_dir / "build.log"))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.uig_error_string.argtypes = [ctypes.c_int]
            lib.uig_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args, stream: int | None = None) -> None:
    """Call C entry point ``name`` on ``stream``, by default the current
    CUDA stream. Tensors pass as device pointers, None as a null pointer,
    and bools, ints and floats as the entry point's SIGNATURES say; the
    caller has checked the tensors' device, type, shape and contiguity. The
    stream is read with ``torch._C._cuda_getCurrentRawStream``:
    ``torch.cuda.current_stream()`` builds a Stream object, several
    microseconds of host time a launch on the card's host, where the step's
    small kernels are host-bound."""
    lib = _lib or library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if stream is None:
        stream = torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device())
    err = getattr(lib, name)(*conv, stream)
    if err != 0:
        msg = lib.uig_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: cudaError {err} ({msg})")
