"""CUT (``fastcut256``) and DCLGAN (``dclgan256``) runs of the port from the
command line on the CPU at a tiny size (16² crops of 20² synthetic images,
one residual block, batch 2, taps (4, 8)): ``train`` and its exact resume,
``translate --run-dir``, ``eval-fid`` with the in-training FID on, CUT's
refusal of b2a with JAX's ValueError, and the fields these trainers do not
honour, each refused with NotImplementedError naming its ROADMAP item. No
JAX is run: the trainers are held against JAX in the step files
(``tests/test_torch_{cut,fastcut,cut_bf16,dclgan}_step.py``).

Every comparison is byte equality. The port runs single-threaded here:
PyTorch's multi-threaded CPU conv backward sums in no fixed order."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from uig_torch.checkpoint import CheckpointManager
from uig_torch.cli.__main__ import main
from uig_torch.config import apply_overrides, get_preset
from uig_torch.data import SyntheticUnpairedDataset
from uig_torch.kernels import center_crop_normalize, denormalize_to_u8
from uig_torch.train import CUTTrainer, CycleGANTrainer, DCLGANTrainer
from uig_torch.train.loop import build_trainer, fit

TINY = ["model.image_size=16", "model.n_res_blocks=1", "model.d_layers=2",
        "model.g_base_features=8", "model.d_base_features=8",
        "model.nce_layers=(4,8)", "model.nce_patches=8",
        "model.nce_proj_dim=16", "model.compute_dtype=float32",
        "data.batch_size=2", "data.load_size=20", "data.synthetic_len=12",
        "data.num_workers=1", "opt.pool_size=4", "opt.total_steps=100",
        "run.log_every=2", "run.ckpt_every=2", "run.ckpt_keep=2",
        "eval.sample_grid_every=2", "eval.sample_grid_n=2",
        "eval.fid_every=2", "eval.fid_num_samples=4",
        "eval.fid_batch_size=4", "parallel.num_devices=1"]
PRESETS = ("fastcut256", "dclgan256")


@pytest.fixture(autouse=True)
def one_thread():
    """One thread for PyTorch and for the BLAS libraries (scipy's sqrtm in
    the FID): spinning BLAS threads on a loaded host take several times
    the test's own time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _overrides(tmp, name, extra=()):
    return TINY + [f"run.workdir={tmp}", f"run.name={name}", *extra]


def _train(preset, tmp, name, steps):
    args = ["train", "--preset", preset, "--device", "cpu",
            "--max-steps", str(steps)]
    for o in _overrides(tmp, name):
        args += ["--set", o]
    assert main(args) == 0


@pytest.fixture(scope="module", params=PRESETS)
def run(request, tmp_path_factory):
    """Run A: 4 steps unbroken. Run B: 2 steps, then resumed to 4."""
    preset = request.param
    tmp = str(tmp_path_factory.mktemp(preset))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            _train(preset, tmp, "a", 4)
            _train(preset, tmp, "b", 2)
            _train(preset, tmp, "b", 4)
    finally:
        torch.set_num_threads(n)
    return preset, tmp


def test_resume_is_byte_identical(run):
    preset, tmp = run
    (ta, ma), (tb, mb) = (
        CheckpointManager(os.path.join(tmp, r, "ckpt")).read()
        for r in ("a", "b"))
    assert ma["step"] == mb["step"] == 4
    assert ma["ints"] == mb["ints"] and ma["ints"]["g_opt/count"] == 4
    assert ma["data_state"] == mb["data_state"]
    assert set(ta) == set(tb)
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not differ, differ[:5]
    heads = [k for k in ta if "/heads/" in k and k.startswith("g_params/")]
    assert len(heads) == 4 * (2 if preset == "dclgan256" else 1) * 2
    recs = [json.loads(line) for line in
            open(os.path.join(tmp, "b", "metrics.jsonl"))]
    fids = [r["fid"] for r in recs if "fid" in r]
    assert len(fids) == 2 and all(np.isfinite(fids))
    names = {"fastcut256": ("nce", "nce_idt"), "dclgan256": ("nce_a", "nce_b")}
    assert all(np.isfinite(r[k]) for r in recs if "g_loss" in r
               for k in names[preset])
    grid = np.asarray(Image.open(os.path.join(tmp, "a", "samples",
                                              "step_00000004.png")))
    rows = 2 if preset == "fastcut256" else 4  # (A, A->B) [+ (B, B->A)]
    assert grid.shape == (rows * 16, 2 * 16, 3)


def test_translate_and_eval_fid(run, tmp_path, capsys):
    """``translate --run-dir`` gives the EMA translate of the newest
    checkpoint; ``eval-fid`` runs on it; CUT refuses b2a as JAX does."""
    preset, tmp = run
    run_a = os.path.join(tmp, "a")
    imgs = SyntheticUnpairedDataset(3, 20, 9).domain_a
    src = tmp_path / "in"
    src.mkdir()
    for i in range(3):
        Image.fromarray(imgs[i]).save(src / f"im{i}.png")
    cfg = apply_overrides(get_preset(preset), _overrides(tmp, "a"))
    tr = build_trainer(cfg, "cpu")
    state, _, _ = CheckpointManager(os.path.join(run_a, "ckpt")).restore(
        tr.init_state(0))
    raw = torch.from_numpy(np.stack([imgs[i] for i in range(3)]))
    for direction in tr.directions:
        out = tmp_path / direction
        assert main(["translate", "--run-dir", run_a, "--input-dir", str(src),
                     "--output-dir", str(out), "--direction", direction,
                     "--batch-size", "2", "--device", "cpu"]) == 0
        want = denormalize_to_u8(tr.translate(
            state.ema, center_crop_normalize(raw, 16), direction)).numpy()
        got = np.stack([np.asarray(Image.open(out / f"im{i}.png"))
                        for i in range(3)])
        np.testing.assert_array_equal(got, want)
        assert main(["eval-fid", "--run-dir", run_a, "--device", "cpu",
                     "--num-samples", "4", "--batch-size", "4",
                     "--direction", direction]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-2]
        assert line.startswith(f"FID[random_conv] over 4 samples "
                               f"({direction}): ")
    if preset == "fastcut256":
        assert tr.directions == ("a2b",)
        with pytest.raises(ValueError, match="single-direction"):
            tr.translate(state.ema, torch.zeros(1, 16, 16, 3), "b2a")
        for cmd in (["translate", "--input-dir", str(src), "--output-dir",
                     str(tmp_path / "x")], ["eval-fid"]):
            with pytest.raises(ValueError, match="single-direction"):
                main([*cmd, "--run-dir", run_a, "--direction", "b2a",
                      "--device", "cpu"])


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("override,match", [
    ("loss.r1_gamma=1.0", "item 7"),
    ("loss.ada_target=0.6", "item 7"),
    ("loss.ada_p_init=0.2", "item 7"),
    ("opt.grad_accum=2", "item 7"),
    ("model.remat=full", "item 6"),
    ("model.remat=blocks", "item 6"),
])
def test_unhonoured_fields_raise(preset, override, match):
    cfg = apply_overrides(get_preset(preset), TINY + [override])
    with pytest.raises(NotImplementedError, match=match):
        build_trainer(cfg, "cpu")


@pytest.mark.parametrize("preset", ("cut256_multihost", "dclgan256"))
def test_multihost_refused_and_one_process_trains(preset, tmp_path):
    """``cut256_multihost`` as published asks for several processes, which
    ``fit`` refuses (ROADMAP §1 item 12); with ``parallel.multihost=false``
    it trains in one."""
    over = _overrides(str(tmp_path), "m", ["eval.fid_every=0",
                                           "eval.sample_grid_every=0"])
    cfg = apply_overrides(get_preset(preset),
                          over + ["parallel.multihost=true"])
    with pytest.raises(NotImplementedError, match="item 12"):
        fit(cfg, max_steps=1, device="cpu")
    m = fit(apply_overrides(cfg, ["parallel.multihost=false"]), max_steps=1,
            device="cpu")
    assert all(np.isfinite(v) for v in m.values())


def test_kinds_build_their_trainers_and_check_taps():
    """build_trainer's new kinds, JAX's ValueErrors for out-of-range taps
    and for DCLGAN with fused applies, and bf16 allowed for both kinds."""
    for preset, cls in (("fastcut256", CUTTrainer),
                        ("dclgan256", DCLGANTrainer)):
        cfg = apply_overrides(get_preset(preset), TINY)
        assert type(build_trainer(cfg, "cpu")) is cls
        bf16 = build_trainer(apply_overrides(
            cfg, ["model.compute_dtype=bfloat16",
                  "model.eval_dtype=bfloat16"]), "cpu")
        assert bf16.dtype == torch.bfloat16
        with pytest.raises(ValueError, match="out-of-range taps"):
            cls(apply_overrides(cfg, ["model.nce_layers=(4,99)"]), "cpu")
    with pytest.raises(ValueError, match="fused_applies"):
        DCLGANTrainer(apply_overrides(get_preset("dclgan256"),
                                      TINY + ["model.fused_applies=true"]),
                      "cpu")
    # serving (translate, serve): the ResNet generator of either kind; CUT
    # serves a2b only
    from uig_torch.serving import Translator

    tr = build_trainer(apply_overrides(get_preset("dclgan256"), TINY), "cpu")
    ema = tr.init_state(0).ema
    over = [o for o in TINY if o.startswith(("model.", "data."))]
    for preset, direction in (("dclgan256", "b2a"), ("fastcut256", "a2b")):
        t = Translator(preset, ema[direction], direction, batch_size=2,
                       device="cpu", overrides=over)
        x = np.zeros((1, 20, 20, 3), np.uint8)
        assert t(x).shape == (1, 16, 16, 3) and t.meta["kind"] in (
            "cut", "dclgan")
    with pytest.raises(ValueError, match="single-direction"):
        Translator("fastcut256", ema["a2b"], "b2a", device="cpu",
                   overrides=over)


def test_cyclegan_trainer_takes_antialias():
    """model.resample=antialias, as JAX's CycleGANTrainer takes it: the
    trainer builds the antialias generator and steps (the generator itself
    is held against flax in tests/test_torch_generator.py and
    tests/test_torch_cut.py, and inside the FastCUT/CUT trainer pattern by
    the step files)."""
    cfg = apply_overrides(get_preset("cyclegan256_dp"), [
        "model.image_size=16", "data.load_size=20", "data.batch_size=2",
        "model.g_base_features=8", "model.n_res_blocks=1",
        "model.d_base_features=8", "model.d_layers=2",
        "model.compute_dtype=float32", "loss.lambda_lpips=0",
        "model.resample=antialias"])
    tr = CycleGANTrainer(cfg, device="cpu")
    assert tr.generator.num_layers == 3 + 8 + 1 + 8 + 2
    state = tr.init_state(0)
    rng = np.random.default_rng(0)
    batch = tuple(rng.integers(0, 256, (2, 20, 20, 3), dtype=np.uint8)
                  for _ in range(2))
    state, m = tr.train_step(state, batch)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert tr.translate(state.ema, torch.zeros(1, 16, 16, 3)).shape == \
        (1, 16, 16, 3)
