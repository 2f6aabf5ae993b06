"""Guards of the port's boundaries: it imports nothing of JAX or the JAX
package, it builds no kernel at import, its entry points need the card
unless asked for the CPU, and chip_smoke.py refuses to report without the
repository or a card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "uig_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "uig")


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_uig_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_out_and_builds_nothing():
    code = ("import sys; import uig_torch.serving, uig_torch.serve, "
            "uig_torch.cli.__main__, uig_torch.kernels._build as b; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'uig' or m.startswith('uig.') for m in sys.modules); "
            "assert b._lib is None")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_resolve_device():
    import torch

    from uig_torch.runtime import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    if not torch.cuda.is_available():
        for dev in ("cuda", None, "cuda:0"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                resolve_device(dev)


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
