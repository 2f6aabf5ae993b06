"""Guards of the port's boundaries: it imports nothing of JAX or the JAX
package, it builds no kernel at import, its entry points need the card
unless asked for the CPU, and chip_smoke.py refuses to report without the
repository or a card; and chip_smoke.py's own readings and checks on
small CPU inputs."""

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


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "tools").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_uig_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_out_and_builds_nothing():
    code = ("import sys; import uig_torch.serving, uig_torch.serve, "
            "uig_torch.cli.__main__, uig_torch.train.cyclegan, "
            "uig_torch.models.vqgan, uig_torch.train.vqgan, "
            "uig_torch.convert, uig_torch.kernels.conv_s2, uig_torch.eval, "
            "uig_torch.data, uig_torch.checkpoint, uig_torch.metrics, "
            "uig_torch.train.loop, uig_torch.cli.train, "
            "uig_torch.kernels._build as b; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'uig' or m.startswith('uig.') for m in sys.modules); "
            "assert b._lib is None")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_vqgan_trains_in_bf16_and_serves_in_fp32():
    """vqgan512 as published trains in bf16 (its compute dtype is the
    default's); serving stays fp32 as published, and a bf16 eval_dtype
    builds a bf16 eval generator."""
    import torch

    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.models import model_dtype
    from uig_torch.train import VQGANTrainer

    cfg = get_preset("vqgan512")
    assert model_dtype(cfg.model, "compute_dtype") == torch.bfloat16
    small = apply_overrides(cfg, [
        "model.image_size=32", "data.load_size=36",
        "model.vq_base_features=16", "model.vq_channel_mults=(1,2)",
        "model.vq_embed_dim=8", "model.vq_codebook_size=32",
        "model.vq_attn_resolutions=(16,)", "model.d_layers=2"])
    tr = VQGANTrainer(small, device="cpu")
    assert tr.dtype == tr.generator.encoder.dtype == torch.bfloat16
    assert tr.discriminator.dtype == torch.bfloat16
    assert tr.eval_generator.encoder.dtype == torch.float32
    state = tr.init_state(0)
    x = torch.zeros(1, 32, 32, 3)
    assert tr.translate(state.ema, x).dtype == torch.float32
    tr16 = VQGANTrainer(apply_overrides(small, ["model.eval_dtype=bfloat16"]),
                        device="cpu")
    assert tr16.eval_generator is tr16.generator  # one dtype, one module
    assert tr16.translate(state.ema, x).dtype == torch.bfloat16


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


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_counts_launches_by_function():
    cs = _chip_smoke()
    calls = cs.launches_by_function({
        "void (anonymous namespace)::conv_fwd_wgmma_kernel<16, 0>"
        "(__nv_bfloat16 const*, int)": 3,
        "void (anonymous namespace)::conv_fwd_wgmma_kernel<8, 8>"
        "(__nv_bfloat16 const*, int)": 2,
        "void (anonymous namespace)::conv_fwd_kernel<128>(float const*)": 1,
        "sm90_xmma_gemm_bf16bf16_bf16f32": 4})
    assert calls == {"conv_fwd_wgmma_kernel": 5, "conv_fwd_kernel": 1,
                     "sm90_xmma_gemm_bf16bf16_bf16f32": 4}


@pytest.mark.parametrize("ran", ["fma", "wgmma"])
def test_chip_smoke_reads_the_design_that_ran(ran):
    """The CycleGAN step: each kernel of DESIGNS in one design, no
    attention. "fma" (the id of the fp32 step): K3, K4s's forward, dgrad
    and wgrad and the 7x7 head's forward, dgrad and wgrad in the TF32
    split, "tf32x3" (K4w's kernel and its sum 4 times each); "wgmma": the
    bf16 step (the head's forward on mma.sync, "mma"; K4d and K4w on wgmma,
    K4w with its sum). The norm forward runs its one-launch design and the
    norm backward its two-pass design in both; a step that launches
    another design's function (the removed FMA forward, dgrad and wgrad of
    K4s and of the head, and the norm forward's partials kernel, among
    them), or one design's function too few times, fails."""
    cs = _chip_smoke()
    assert set(cs.DESIGNS) == {"conv3_in_act", "conv7", "conv7_dgrad",
                               "conv7_wgrad", "conv3s2", "conv3s2_dgrad",
                               "conv3s2_wgrad", "instance_norm",
                               "instance_norm_bwd", "attention_fwd",
                               "attention_bwd"}
    assert want_norm(cs, ran) == "one_launch"
    assert "instance_norm" in cs.REPEAT_BIT_EQUAL
    want = cs.STEP_DESIGNS["float32" if ran == "fma" else "bfloat16"]
    assert set(want) == {name for name in cs.DESIGNS if cs.PER_STEP[name]}
    assert want["conv3_in_act"] == ("tf32x3" if ran == "fma" else "wgmma")
    assert want["conv7"] == ("tf32x3" if ran == "fma" else "mma")
    assert want["conv7_dgrad"] == want["conv7_wgrad"] == \
        ("tf32x3" if ran == "fma" else "wgmma")
    assert {"conv7_dgrad", "conv7_wgrad"} <= set(cs.REPEAT_BIT_EQUAL)
    assert want["conv3s2"] == want["conv3s2_dgrad"] == \
        want["conv3s2_wgrad"] == ("tf32x3" if ran == "fma" else "wgmma")
    calls = {fn: cs.PER_STEP[name] for name, d in want.items()
             for fn in cs.design_functions(name, d)}
    assert cs.designs_run(calls, "train", expect=want) == want
    for name, d in want.items():
        for other in set(cs.DESIGNS[name]) - {d}:
            for bad in ({**calls, cs.design_functions(name, other)[0]: 1},
                        {**calls, cs.design_functions(name, d)[-1]:
                         cs.PER_STEP[name] - 1}):
                with pytest.raises(AssertionError, match=name):
                    cs.designs_run(bad, "train")
    with pytest.raises(AssertionError, match="attention_fwd"):
        cs.designs_run({**calls, "attn_fwd_tc_kernel": 1}, "train")
    other = cs.STEP_DESIGNS["bfloat16" if ran == "fma" else "float32"]
    with pytest.raises(AssertionError, match="want"):
        cs.designs_run(calls, "train", expect=other)


def want_norm(cs, ran: str) -> str:
    return cs.STEP_DESIGNS["float32" if ran == "fma" else "bfloat16"][
        "instance_norm"]


def test_chip_smoke_reads_the_slice_designs():
    """fp32 serving: a translate apply runs K3, both downsamples and the
    head in the TF32 split and the norm forward in one launch, each its
    PER_APPLY times; an apply that launched the removed FMA forward of K4s
    or of the head, the norm forward's partials kernel, or the split
    forward once, fails."""
    cs = _chip_smoke()
    calls = {fn: cs.PER_APPLY[name] for name, d in cs.SLICE_DESIGNS.items()
             for fn in cs.design_functions(name, d)}
    assert calls["conv_fwd_tf32_kernel"] == 2
    assert cs.designs_run(calls, "slice", cs.PER_APPLY,
                          cs.SLICE_DESIGNS) == cs.SLICE_DESIGNS
    assert calls["conv7_tf32_kernel"] == 1 and calls["in_fwd_kernel"] == 5
    for bad in ({**calls, "conv_fwd_kernel": 2},
                {**calls, "in_partials_kernel": 5},
                {**calls, "conv_fwd_tf32_kernel": 1},
                {**calls, "conv7_mma_kernel": 1},
                {**calls, "conv7_kernel": 1}):
        with pytest.raises(AssertionError):
            cs.designs_run(bad, "slice", cs.PER_APPLY, cs.SLICE_DESIGNS)


def test_chip_smoke_reads_the_attention_design():
    """The VQGAN step: every function of the tf32x3 attention design its
    VQ_PER_STEP times, none of the FMA design, no conv kernel; the norm
    forward in one launch, the norm backward in its two-pass design."""
    cs = _chip_smoke()
    calls = {fn: cs.VQ_PER_STEP[name] for name, d in
             cs.VQ_STEP_DESIGNS.items()
             for fn in cs.design_functions(name, d)}
    assert len(calls) == 8 and set(calls.values()) == {4, 9, 12}
    assert cs.designs_run(calls, "vqgan_train", cs.VQ_PER_STEP,
                          cs.VQ_STEP_DESIGNS) == {
        "attention_fwd": "tf32x3", "attention_bwd": "tf32x3",
        "instance_norm": "one_launch", "instance_norm_bwd": "two_pass"}
    for bad in ({**calls, "attn_dq_kernel": 4},
                {**calls, "in_partials_kernel": 9},
                {**calls, "attn_dq_tc_kernel": 3},
                {**calls, "conv_fwd_kernel": 1},
                {**calls, "in_bwd_apply_kernel": 12}):
        with pytest.raises(AssertionError):
            cs.designs_run(bad, "vqgan_train", cs.VQ_PER_STEP)
    bound, by = cs.bound_ms(1.0, 495e9, design="tf32x3")
    assert by == "operations" and abs(bound - 3.0) < 1e-12


def test_chip_smoke_bf16_attention_bound_and_check():
    """The bf16 attention bound counts a product of two bf16 operands at the
    bf16 rate and each TF32 term of an fp32-by-bf16 product at the TF32
    rate: K5f 0.043 ms and K5b 0.122 ms a launch at (8, 1024, 512). The
    check passes outputs that are the fp32 computation on the widened
    inputs, rounded (the plain versions on the CPU), and fails one that
    is not."""
    import torch

    from uig_torch.kernels import (attention_bwd, attention_bwd_reference,
                                   attention_fwd, attention_reference)

    cs = _chip_smoke()
    prod = 2.0 * 8 * 1024 * 1024 * 512
    fwd, by = cs.bound_ms(0.0, (prod, prod), "bfloat16", "tf32x3")
    bwd, _ = cs.bound_ms(0.0, (2 * prod, 3 * prod), "bfloat16", "tf32x3")
    assert by == "operations"
    assert abs(4 * fwd - 0.1737) < 1e-3 and abs(4 * bwd - 0.4860) < 1e-3
    gen = torch.Generator().manual_seed(0)
    w = [torch.randn(2, 40, 16, generator=gen).to(torch.bfloat16).float()
         for _ in range(4)]
    q, k, v, do = (t.to(torch.bfloat16) for t in w)
    fwd_check = cs._attention_bf16_check(
        "attention_fwd", lambda: attention_fwd(*w[:3])[0],
        lambda: attention_reference(*w[:3]))
    out = attention_fwd(q, k, v)[::2]
    ref = (attention_reference(q, k, v), attention_reference(*w[:3]))
    _, checked, extra = fwd_check(out, ref)
    assert checked <= 1.0 and extra["bit_equal_fp32_kernel_widened"]
    bwd_check = cs._attention_bf16_check(
        "attention_bwd",
        lambda: attention_bwd(*w[:3], attention_fwd(*w[:3])[0],
                              attention_fwd(*w[:3])[1], w[3]),
        lambda: attention_bwd_reference(*w))
    got = attention_bwd_reference(q, k, v, do)
    assert bwd_check(got, got)[1] <= 1.0
    moved = (got[0], got[1], torch.nextafter(got[2], torch.ones_like(got[2])))
    with pytest.raises(AssertionError, match="bit-equal"):
        bwd_check(moved, got)


def test_chip_smoke_lists_the_wgmma_kernels_ptxas():
    cs = _chip_smoke()
    log = ["conv3_in.cu\n"
           "ptxas info : Compiling entry function '_Z17conv3_gemm_kernel'\n"
           "ptxas info : Used 128 registers\n",
           "conv3_in_tc.cu\n"
           "ptxas info : Compiling entry function '_Z21conv3_in_wgmma_kernel'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info : Used 120 registers\n"
           "ptxas info : Compiling entry function '_Z16in_apply_kernel'\n"
           "ptxas info : Used 30 registers\n"]
    assert cs.wgmma_ptxas(log) == [
        "ptxas info : Compiling entry function '_Z21conv3_in_wgmma_kernel'",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info : Used 120 registers"]


@pytest.mark.parametrize("case", ["plain", "kink_flipped", "past_the_bound"])
def test_chip_smoke_norm_bwd_check_bounds_dgamma_dbeta_by_the_kink(case):
    """With a fused ReLU, an element whose pre-activation sits at the kink
    may take either side in a correct kernel, and dgamma/dbeta move by its
    share: the check passes the plain version's outputs and outputs with
    the kink element flipped, and fails a dbeta moved past that share."""
    import torch

    from uig_torch.kernels import (instance_norm_bwd_reference,
                                   instance_norm_reference)
    from uig_torch.kernels.norm import _instance_norm_fwd

    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 5, 3, generator=gen)
    g = 1.0 + 0.1 * torch.randn(3, generator=gen)
    dy = torch.randn(2, 4, 5, 3, generator=gen)
    # channel 1's pre-activation is exactly 0 at pixel (1, 2, 3)
    xn = instance_norm_reference(x, torch.ones(3), torch.zeros(3))
    b = 0.1 * torch.randn(3, generator=gen)
    b[1] = -(xn[1, 2, 3, 1] * g[1])
    k = (1, 2, 3, 1)
    assert (xn * g + b)[k] == 0
    stats = _instance_norm_fwd(x, g, b, 1e-5, True)[1]
    ref = instance_norm_bwd_reference(x, g, b, dy, stats, relu=True)
    dx, dg, db = (t.clone() for t in ref)
    tol = cs.TOL["instance_norm_bwd"]
    if case == "kink_flipped":  # the other side of the kink: +-dy there
        side = 1.0 if (xn * g + b)[k] > 0 else -1.0
        db[1] -= side * dy[k]
        dg[1] -= side * dy[k] * xn[k]
    elif case == "past_the_bound":
        db[1] += dy[k].abs() + 2 * tol * ref[2].abs().max()
    _, checked, extra = cs._norm_bwd_check(x, g, b, dy, relu=True)(
        (dx, dg, db), ref)
    assert extra["dx_elements_at_relu_kink"] == 1
    assert (checked > tol) == (case == "past_the_bound"), checked


VQ_TINY = ["model.image_size=32", "data.load_size=36", "data.batch_size=2",
           "model.vq_base_features=16", "model.vq_channel_mults=(1,2)",
           "model.vq_embed_dim=8", "model.vq_codebook_size=32",
           "model.vq_attn_resolutions=(16,)", "loss.lambda_lpips=0",
           "loss.vq_disc_start=0"]


@pytest.mark.parametrize("fault", ["none", "zero_g"])
def test_chip_smoke_bf16_vqgan_gate_pins_codes_and_refuses_zero(fault,
                                                               monkeypatch):
    """``compare_card_cpu_bf16`` with CPU trainers in place of the card's
    (a tiny bf16 VQGAN): B16, C16 and A32 take A16's codes, each run's own
    codes agree with them outside the margin, and a zero G gradient from
    A16 is refused."""
    import numpy as np
    import torch

    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.train import VQGANTrainer

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    runs = []

    class OnCPU(VQGANTrainer):
        def __init__(self, cfg, device="cpu"):
            super().__init__(cfg, device="cpu")

        def _grads(self, state, batch, draws):
            grads, m = super()._grads(state, batch, draws)
            if fault == "zero_g" and not runs:  # A16, the first run
                grads["g"] = {k: torch.zeros_like(v)
                              for k, v in grads["g"].items()}
            runs.append(self.dtype)
            return grads, m

    cfg = apply_overrides(get_preset("vqgan512"), VQ_TINY)
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
            for _ in range(2))
    keys = ("g_loss", "d_loss", "rec", "codebook", "g_adv", "perplexity",
            "lambda_adapt")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if fault == "zero_g":
            with pytest.raises(AssertionError, match="g_grad"):
                cs.compare_card_cpu_bf16(OnCPU, cfg, a, b, keys, "tiny",
                                         ("lambda_adapt", "g_loss"))
            return
        out = cs.compare_card_cpu_bf16(OnCPU, cfg, a, b, keys, "tiny",
                                       ("lambda_adapt", "g_loss"))
    finally:
        torch.set_num_threads(threads)
    assert runs == [torch.bfloat16, torch.bfloat16, torch.float32,
                    torch.bfloat16]
    for name in ("B16", "C16", "A32"):
        agree = out[f"codes_A16_{name}"]
        assert agree["differ_checked"] == 0, agree
    # the fp32 step, pinned to the bf16 codes, differs where bf16 rounds
    assert 0 < out["g_grad_norm_gap"]["A16_A32"] < 0.5
