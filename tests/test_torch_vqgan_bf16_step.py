"""The port's VQGAN training step in bf16 against the JAX ``VQGANTrainer``
in bf16 (``model.compute_dtype=bfloat16``, the ``vqgan512`` preset's
default), from one carried state, with the same draws.

The small configuration is ``tests/test_torch_vqgan_step.py``'s, in bf16:
step 0 runs with D gated off, step 1 with D, its update and the
adversarial term on; both take the adaptive weight. One state, drawn by
the port's ``init_state``, crosses into JAX's ``VQGANState``
(``make_mesh(1)``; parameters, Adam and the EMA are fp32 in both dtypes)
through ``uig_torch.convert``; both packages take ``STEPS`` steps on the
same uint8 batches with the JAX step's crop offsets and flips, JAX under
its trainer's one ``jax.jit``. The port also takes the same steps in fp32
from the same state, the yardstick for what bf16 itself moves. The port
runs on the CPU (plain versions of every kernel), single-threaded so that
its rounding does not vary between processes.

Two things would otherwise drown the comparison in noise:
  * XLA on the CPU by default keeps fp32 across a fusion's bf16 roundings
    (``xla_allow_excess_precision``), and it fuses the step's two forwards
    (the adaptive weight's and the loss's) apart, so that they chose
    different codes for 6 of 1024 latents. The JAX step is compiled with
    that off (``JAX_OPTIONS``): it rounds where its program says, as the
    port does, and its two forwards choose the same codes.
  * Codes. bf16 latents of the two packages differ by rounding (sums in
    another order round apart, and each such element moves what follows),
    and a latent within that of two codewords takes either code: 11 to 23
    of 1024 latents differed at each step, and the G gradient's gap was
    0.58 to 0.82 of its norm, the same for the port's fp32 step, while the
    port's bf16 step pinned to its fp32 step's codes sat 0.13 from it. So
    JAX's quantizer reports its codes through a callback, the port's own
    codes must agree with them wherever the two nearest codewords are
    further apart than the latents' difference can move them
    (``chip_smoke._code_agreement``, for most latents), and the port's
    steps take JAX's codes (``pin_codes``).

Gates, each with what it reads here and the planted faults it must refuse
(``test_gates_refuse_planted_fault``):
  * gradients (read from JAX's Adam moments) per network: the port's bf16
    step within GAP = sqrt(2) times the distance of its fp32 step from
    JAX's, in the Euclidean norm over the network: a port that rounded
    at other places than JAX, with noise of the same size, would sit
    sqrt(2) times as far; rounding where JAX does, it sits nearer. Read:
    G 0.09 and 0.18 of the norm of JAX's G gradient against fp32's 0.12
    and 0.20, D 0.10 against 0.15. A conv bias before a GroupNorm has a
    true gradient of 0 and both packages return rounding noise there:
    those leaves are left out. Refuses a zero G gradient and the gradient
    of half the batch (0.97 and 0.88), and a bf16 GroupNorm backward that
    halves its mean term (0.22 at step 0; ``tests/test_torch_vqgan.py``
    holds that backward within one bf16 ulp);
  * ``rec``, the L1 term over the bf16 images: within half the fp32 step's
    relative gap, since both bf16 steps round the reconstruction and the
    fp32 step does not (read: 2e-5 and 5e-5 against 8e-4 and 7e-4).
    Refuses the step computed in fp32;
  * ``lambda_adapt``, a ratio of two gradient norms at the decoder's last
    kernel, moves as those gradients do (| |a| - |b| | <= |a - b|): within
    twice the fp32 step's relative G-gradient gap (read: 3e-4 and 5e-2
    against limits of 0.24 and 0.40). Refuses it doubled;
  * the other metrics within ``RTOL_LOSS`` = 2^-6 relative (a few bf16
    ulps of each loss, means over bf16 images);
  * the parameters and the EMA after the step: within GAP times the fp32
    step's distance (read: 0.81 to 0.98 of it), leaving out the GN-fed
    biases, whose +-lr Adam steps follow the sign of noise.
"""

import contextlib
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from test_torch_vqgan_step import (B1, DISC_START, OVERRIDES, _flat,
                                   _jax_state, jax_draws)
from uig.config import apply_overrides as jax_apply_overrides
from uig.config import get_preset as jax_get_preset
from uig.models.vqgan import VectorQuantizer as JaxVQ
from uig.runtime import make_mesh
from uig.train.vqgan_trainer import VQGANTrainer as JaxTrainer
from uig_torch.config import apply_overrides, get_preset
from uig_torch.convert import (jax_flat_from_train_state,
                               train_state_from_jax_flat)
from uig_torch.models.vqgan import pin_codes
from uig_torch.train import VQGANState, VQGANTrainer

BF16 = [o for o in OVERRIDES if not o.startswith("model.compute_dtype")] \
    + ["model.compute_dtype=bfloat16"]
STEPS = 2
DATA_SEED = 1
RTOL_LOSS = 2.0 ** -6
JAX_OPTIONS = {"xla_allow_excess_precision": False}
GAP = float(np.sqrt(2.0))
FAULTS = ("zero_g", "half_batch_g", "fp32_step", "lambda_x2")


def _code_agreement():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._code_agreement


@contextlib.contextmanager
def _jax_codes():
    """Within the block, every forward of JAX's quantizer appends its
    (codes, fp32 latents) to the yielded list, through a callback."""
    got, call = [], JaxVQ.__call__

    def reporting(self, z):
        out = call(self, z)
        jax.debug.callback(lambda c, z: got.append(
            (np.array(c), np.asarray(z, np.float32))), out.codes, z)
        return out

    JaxVQ.__call__ = reporting
    try:
        yield got
    finally:
        JaxVQ.__call__ = call


def _half(batch, draws):
    """The first image of each domain's batch, and its draws."""
    return ((batch[0][:1], batch[1][:1]),
            {k: tuple(t[:1] for t in v) for k, v in draws.items()})


@pytest.fixture(scope="module")
def runs():
    jtr = JaxTrainer(jax_apply_overrides(jax_get_preset("vqgan512"), BF16),
                     make_mesh(1))
    cfg = apply_overrides(get_preset("vqgan512"), BF16)
    port = {"bf16": VQGANTrainer(cfg, device="cpu"),
            "fp32": VQGANTrainer(apply_overrides(
                cfg, ["model.compute_dtype=float32"]), device="cpu")}
    init = jax_flat_from_train_state(port["bf16"].init_state(0))
    init["rng"] = np.asarray(jax.random.PRNGKey(0))
    jstate = _jax_state(jtr, init)
    rng = np.random.default_rng(DATA_SEED)
    batches = [tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                     for _ in range(2)) for _ in range(STEPS)]
    flat0 = _flat(jstate)
    states = {k: train_state_from_jax_flat(flat0, VQGANState, seed=0)
              for k in port}
    out = {"jax": [], "jax_metrics": [], "codes": [],
           **{k: {"flat": [], "metrics": [], "grads": []} for k in port},
           "half": {"grads": []}}
    z, agreement = {}, _code_agreement()
    port["bf16"].generator.encoder.register_forward_hook(
        lambda m, i, o: z.__setitem__("port", o.detach().float()))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _jax_codes() as jax_codes:
        step_fn = jtr._train_step.lower(jstate, *batches[0]).compile(
            compiler_options=JAX_OPTIONS)
        try:
            for step in range(STEPS):
                draws = jax_draws(jstate, step, 2, 36, 32)
                jax_codes.clear()
                jstate, metrics = step_fn(jstate, *batches[step])
                jax.effects_barrier()
                out["jax_metrics"].append(
                    {k: float(v) for k, v in metrics.items()})
                out["jax"].append(_flat(jstate))
                (codes, z_jax), (codes2, _) = jax_codes
                bf16 = port["bf16"]
                # the union batch is [a, b]: the halves' latents are 0 and 2
                with pin_codes(bf16.generator.quantizer, codes[[0, 2]]):
                    half, _ = bf16._grads(states["bf16"],
                                          *_half(batches[step], draws))
                out["half"]["grads"].append(half)
                for k, tr in port.items():
                    with pin_codes(tr.generator.quantizer, codes):
                        grads, m = tr._grads(states[k], batches[step], draws)
                    if k == "bf16":
                        cb = states[k].g_params["quantizer.codebook"]
                        own = functional_call(tr.generator.quantizer,
                                              {"codebook": cb}, (z["port"],))
                        agree = agreement(
                            z["port"], torch.from_numpy(z_jax), own.codes,
                            torch.from_numpy(codes), cb)
                    tr._update(states[k], grads)
                    out[k]["metrics"].append(
                        {n: float(v) for n, v in m.items()})
                    out[k]["flat"].append(jax_flat_from_train_state(states[k]))
                    out[k]["grads"].append(grads)
                out["codes"].append({"jax_forwards_differ": int(
                    (codes != codes2).sum()), **agree})
        finally:
            torch.set_num_threads(threads)
    out["dtype"] = port["bf16"].generator.encoder.Conv_0.dtype
    return out


def _jax_grads(runs, opt: str, step: int) -> dict:
    """{leaf key: JAX gradient at ``step``}, from the fp32 Adam moments."""
    pre = f"{opt}/0/0/mu/"
    mu = {k[len(pre):]: v for k, v in runs["jax"][step].items()
          if k.startswith(pre)}
    if step == (DISC_START if opt == "d_opt" else 0):
        return {k: v / (1.0 - B1) for k, v in mu.items()}
    prev = runs["jax"][step - 1]
    return {k: (v - B1 * prev[pre + k]) / (1.0 - B1) for k, v in mu.items()}


def _port_grads(runs, kind: str, which: str, step: int) -> dict:
    tree = runs[kind]["grads"][step][which]
    return {f"params/{path.replace('.', '/')}": t.numpy()
            for path, t in tree.items()}


def _gn_fed_biases(keys) -> set:
    """The conv biases followed by a GroupNorm (``.../Conv_i/bias`` of a
    block whose next op is its GN): every VQResBlock's Conv_0, whose true
    gradient is 0."""
    return {k for k in keys if "/VQResBlock_" in k
            and k.endswith("/Conv_0/bias")}


def _dist(got: dict, want: dict) -> float:
    return float(np.sqrt(sum(
        np.sum((np.asarray(got[k], np.float64) - want[k]) ** 2)
        for k in want)))


def _grads_gate(got: dict, got32: dict, want: dict) -> tuple:
    """(passes, bf16 gap, fp32 gap), the gaps relative to |want|."""
    scale = _dist({k: 0.0 for k in want}, want)
    d16, d32 = _dist(got, want) / scale, _dist(got32, want) / scale
    return d16 <= GAP * d32, d16, d32


def _g_grads(runs, kind: str, step: int) -> dict:
    return _port_grads(runs, kind, "g", step)


def _g_want(runs, step: int) -> dict:
    want = _jax_grads(runs, "g_opt", step)
    return {k: v for k, v in want.items() if k not in _gn_fed_biases(want)}


def _metric_failures(runs, step: int, got: dict, got32: dict) -> list:
    """The metrics of ``got`` (the fp32 step's: ``got32``) that fail their
    gate against JAX's at ``step``."""
    want = runs["jax_metrics"][step]
    rel32 = _grads_gate(_g_grads(runs, "fp32", step),
                        _g_grads(runs, "fp32", step), _g_want(runs, step))[2]
    bad = []
    for k in want:
        rel = abs(got[k] / want[k] - 1) if want[k] else abs(got[k])
        if k == "lambda_adapt":
            ok = rel <= 2 * rel32
        elif k == "rec":
            ok = rel <= abs(got32[k] / want[k] - 1) / 2
        else:
            ok = abs(got[k] - want[k]) <= 1e-6 + RTOL_LOSS * abs(want[k])
        if not ok:
            bad.append(k)
    return bad


def _within_fp32_gap(runs, want: dict, get, what: str, capsys) -> None:
    ok, d16, d32 = _grads_gate(get("bf16"), get("fp32"), want)
    with capsys.disabled():
        print(f"\n{what}: |port bf16 - jax bf16| {d16:.3e}, "
              f"|port fp32 - jax bf16| {d32:.3e} (of |jax|)")
    assert ok, f"{what}: bf16 gap {d16:.4g} > {GAP:.3f} x fp32 gap {d32:.4g}"


def test_trains_in_bf16(runs):
    assert runs["dtype"] == torch.bfloat16


@pytest.mark.parametrize("step", range(STEPS))
def test_codes_agree(runs, step, capsys):
    """JAX's two forwards choose the same codes, and the port's own agree
    with them outside the rounding margin, for most latents."""
    agree = runs["codes"][step]
    with capsys.disabled():
        print(f"\nstep {step} codes: {agree}")
    assert agree["jax_forwards_differ"] == 0
    assert agree["differ_checked"] == 0
    assert agree["checked"] > agree["latents"] // 2


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics(runs, step, capsys):
    want, got = runs["jax_metrics"][step], runs["bf16"]["metrics"][step]
    got32 = runs["fp32"]["metrics"][step]
    assert set(got) == set(want)
    with capsys.disabled():
        print("\n" + ", ".join(f"{k} {got[k] / want[k] - 1:+.2e} (fp32 "
                               f"{got32[k] / want[k] - 1:+.2e})"
                               for k in want if want[k]))
    assert not _metric_failures(runs, step, got, got32)
    assert (got["d_loss"] == 0.0) == (step < DISC_START)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("opt,which", [("g_opt", "g"), ("d_opt", "d")])
def test_gradients_within_fp32_gap(runs, step, opt, which, capsys):
    if which == "d" and step < DISC_START:
        assert runs["bf16"]["grads"][step]["d"] is None  # D gated off
        return
    want = _jax_grads(runs, opt, step)
    want = {k: v for k, v in want.items() if k not in _gn_fed_biases(want)}
    _within_fp32_gap(
        runs, want, lambda kind: _port_grads(runs, kind, which, step),
        f"step {step} {which} gradients", capsys)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("fault", FAULTS)
def test_gates_refuse_planted_fault(runs, fault, step, capsys):
    """Each planted fault fails the gate that is there to catch it."""
    want, g32 = _g_want(runs, step), _g_grads(runs, "fp32", step)
    m16, m32 = runs["bf16"]["metrics"][step], runs["fp32"]["metrics"][step]
    if fault in ("zero_g", "half_batch_g"):
        got = ({k: np.zeros_like(v) for k, v in want.items()}
               if fault == "zero_g" else _g_grads(runs, "half", step))
        ok, d16, d32 = _grads_gate(got, g32, want)
        reading = f"gap {d16:.3f}, limit {GAP * d32:.3f}"
        assert not ok, reading
    elif fault == "fp32_step":
        bad = _metric_failures(runs, step, m32, m32)
        reading = bad
        assert "rec" in bad
    else:
        doubled = {**m16, "lambda_adapt": 2 * m16["lambda_adapt"]}
        bad = _metric_failures(runs, step, doubled, m32)
        reading = bad
        assert "lambda_adapt" in bad
    with capsys.disabled():
        print(f"\nstep {step} {fault}: refused ({reading})")


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("tree", ["g_params", "d_params", "ema"])
def test_params_within_fp32_gap(runs, step, tree, capsys):
    want = {k: v for k, v in runs["jax"][step].items()
            if k.startswith(tree + "/")}
    noise = _gn_fed_biases(want)
    assert tree == "d_params" or noise
    want = {k: v for k, v in want.items() if k not in noise}
    _within_fp32_gap(runs, want, lambda kind: {k: runs[kind]["flat"][step][k]
                                               for k in want},
                     f"step {step} {tree}", capsys)
