"""The port's training entry point on the CPU at a tiny size (16² crops of
20² synthetic images, one residual block, batch 2, the size of
``tests/integration/test_resume.py``): ``fit``, its checkpoints and exact
resume, the metrics file, SIGTERM, the refused config fields, and the
``train``/``translate --run-dir`` commands. No JAX trainer is built: the
JAX package is the reference only for ``config.json``, which must be the
text JAX's ``fit`` writes for the same preset and overrides.

Tolerances: every comparison is byte equality (tensors with
``torch.equal``, files byte for byte). The port runs single-threaded here:
PyTorch's multi-threaded CPU conv backward sums in no fixed order."""

import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from uig.config import apply_overrides as jax_overrides
from uig.config import config_to_dict as jax_config_to_dict
from uig.config import get_preset as jax_preset
from uig_torch.checkpoint import CheckpointManager, ckpt as ckpt_mod
from uig_torch.cli.__main__ import main
from uig_torch.config import apply_overrides, get_preset
from uig_torch.train import CycleGANTrainer
from uig_torch.train.loop import build_trainer, fit, fix_cublas_workspace

TINY = ["model.image_size=16", "model.n_res_blocks=1", "model.d_layers=2",
        "model.g_base_features=8", "model.d_base_features=8",
        "data.batch_size=2", "data.load_size=20", "data.synthetic_len=12",
        "data.num_workers=1", "opt.pool_size=4", "opt.total_steps=100",
        "run.log_every=2", "run.ckpt_every=2", "run.ckpt_keep=2",
        "eval.sample_grid_every=3", "eval.sample_grid_n=2"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(tmp, name, extra=()):
    return TINY + [f"run.workdir={tmp}", f"run.name={name}", *extra]


def _cfg(tmp, name, extra=()):
    return apply_overrides(get_preset("smoke64"), _overrides(tmp, name, extra))


def _train(tmp, name, steps, extra=()):
    args = ["train", "--preset", "smoke64", "--device", "cpu",
            "--max-steps", str(steps)]
    for o in _overrides(tmp, name, extra):
        args += ["--set", o]
    assert main(args) == 0


def _final(tmp, name):
    """Every tensor, integer and the cursor of the newest checkpoint."""
    tensors, meta = CheckpointManager(os.path.join(tmp, name, "ckpt")).read()
    return tensors, meta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: 6 steps unbroken. Run B: 3 steps (checkpoints at 2 and, the
    final save, 3), then a second ``train`` that restores step 3 and goes
    on to 6. Both through the CLI; a checkpoint every 2 steps, the last 2
    kept."""
    tmp = str(tmp_path_factory.mktemp("runs"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _train(tmp, "a", 6)
        _train(tmp, "b", 3)
        _train(tmp, "b", 6)
    finally:
        torch.set_num_threads(n)
    return tmp


def test_resume_is_byte_identical(runs):
    ta, ma = _final(runs, "a")
    tb, mb = _final(runs, "b")
    assert ma["step"] == mb["step"] == 6
    assert ma["data_state"] == mb["data_state"] == {"t_consumed": 6}
    assert ma["ints"] == mb["ints"]
    assert ma["ints"]["g_opt/count"] == 6 and ma["ints"]["pool_a/count"] == 4
    assert set(ta) == set(tb) and len(ta) > 100
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not differ, differ[:5]
    # not trivially equal: the run moved the parameters from their init
    init = CycleGANTrainer(_cfg(runs, "x"), "cpu").init_state(0)
    w = "g_params/a2b/layers_0.kernel"
    assert not torch.equal(ta[w], init.g_params["a2b"]["layers_0.kernel"])


def test_metrics_samples_and_keep_last(runs):
    recs = [json.loads(line) for line in
            open(os.path.join(runs, "a", "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [2, 4, 6]
    for r in recs:
        for k in ("g_loss", "d_loss", "input_stall_pct",
                  "images_per_sec_chip", "lr"):
            assert np.isfinite(r[k]), k
        assert "hbm_gb_in_use" not in r  # the CPU has no device memory
    assert sorted(os.listdir(os.path.join(runs, "a", "samples"))) == [
        "step_00000003.png", "step_00000006.png"]
    grid = np.asarray(Image.open(os.path.join(runs, "a", "samples",
                                              "step_00000006.png")))
    assert grid.shape == (4 * 16, 2 * 16, 3)  # (A, A->B, B, B->A) x 2 images
    # run B's file continues across the resume
    recs_b = [json.loads(line) for line in
              open(os.path.join(runs, "b", "metrics.jsonl"))]
    assert [r["step"] for r in recs_b] == [2, 4, 6]
    # keep-last-2 of the saves at 2, 4, 6 (and run B's final save at 3)
    for run in ("a", "b"):
        assert sorted(os.listdir(os.path.join(runs, run, "ckpt"))) == ["4", "6"]


def test_rerun_of_a_finished_run_takes_no_step(runs, tmp_path):
    """``train`` again at the step a run ended on restores it, takes no step
    and writes no checkpoint."""
    shutil.copytree(os.path.join(runs, "a"), tmp_path / "a")
    before = os.stat(tmp_path / "a" / "ckpt" / "6" / "state.pt").st_mtime_ns
    _train(str(tmp_path), "a", 6)
    assert os.stat(tmp_path / "a" / "ckpt" / "6" /
                   "state.pt").st_mtime_ns == before
    assert sorted(os.listdir(tmp_path / "a" / "ckpt")) == ["4", "6"]


def test_config_json_is_jax_fit_s(runs):
    """The text JAX's ``fit`` writes (``dump_run_config``) for the same
    preset and overrides."""
    jcfg = jax_overrides(jax_preset("smoke64"), _overrides(runs, "a"))
    want = json.dumps(jax_config_to_dict(jcfg), indent=2, sort_keys=True)
    assert open(os.path.join(runs, "a", "config.json")).read() == want


def test_translate_run_dir(runs, tmp_path):
    """``translate --run-dir`` reads config.json and the newest (or
    ``--step``) checkpoint's EMA; its PNGs equal a direct call of the
    trainer's EMA translate on the same images."""
    from uig_torch.data import SyntheticUnpairedDataset
    from uig_torch.kernels import center_crop_normalize, denormalize_to_u8

    src = tmp_path / "in"
    src.mkdir()
    imgs = SyntheticUnpairedDataset(3, 20, 9).domain_a
    for i in range(3):
        Image.fromarray(imgs[i]).save(src / f"im{i}.png")
    for step, sub in ((None, "new"), (4, "old")):
        args = ["translate", "--run-dir", os.path.join(runs, "a"),
                "--input-dir", str(src), "--output-dir", str(tmp_path / sub),
                "--direction", "b2a", "--batch-size", "2", "--device", "cpu"]
        assert main(args + ([] if step is None else ["--step", str(step)])) == 0
    cfg = _cfg(runs, "a")
    tr = CycleGANTrainer(cfg, "cpu")
    for step, sub in ((6, "new"), (4, "old")):
        state, _, _ = CheckpointManager(os.path.join(runs, "a", "ckpt")).restore(
            tr.init_state(0), step)
        raw = torch.from_numpy(np.stack([imgs[i] for i in range(3)]))
        want = denormalize_to_u8(tr.translate(
            state.ema, center_crop_normalize(raw, 16), "b2a")).numpy()
        got = np.stack([np.asarray(Image.open(tmp_path / sub / f"im{i}.png"))
                        for i in range(3)])
        np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit):
        main(["translate", "--run-dir", runs, "--weights", "g.npz",
              "--input-dir", str(src), "--output-dir", str(tmp_path / "x")])


def test_interrupted_save(runs, tmp_path, monkeypatch):
    """A save killed between its write and its rename leaves the previous
    checkpoint the newest and restorable, and the next save sweeps the
    leftover and keeps the last 2."""
    d = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(runs, "a", "ckpt"), d)
    tr = CycleGANTrainer(_cfg(runs, "a"), "cpu")
    state, data_state, _ = CheckpointManager(d).restore(tr.init_state(0))
    assert state.step == 6 and data_state == {"t_consumed": 6}

    def killed(src, dst):
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(ckpt_mod.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        CheckpointManager(d, keep=2).save(7, state, {"t_consumed": 7})
    monkeypatch.undo()
    assert any(n.startswith(".tmp-") for n in os.listdir(d))
    mgr = CheckpointManager(d, keep=2)
    assert mgr.latest_step() == 6
    back, _, _ = mgr.restore(tr.init_state(1))
    assert back.step == 6 and back.seed == 0
    assert torch.equal(back.g_params["a2b"]["layers_0.kernel"],
                       state.g_params["a2b"]["layers_0.kernel"])
    mgr.save(7, back, {"t_consumed": 7})
    assert sorted(os.listdir(d)) == ["6", "7"]


def test_sigterm_saves_the_step_reached(tmp_path, monkeypatch):
    """SIGTERM during step 2 (raised by the step itself, so no timing is
    involved) ends the loop after that step with a checkpoint at 2, and
    ``fit`` puts the handlers back; the run also profiles its first step."""
    step = CycleGANTrainer.train_step

    def step_then_signal(self, state, batch, draws=None):
        out = step(self, state, batch, draws)
        if out[0].step == 2:
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(CycleGANTrainer, "train_step", step_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    cfg = _cfg(str(tmp_path), "s", ["eval.sample_grid_every=0",
                                    "run.profile_steps=(0,1)"])
    metrics = fit(cfg, max_steps=10, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    mgr = CheckpointManager(os.path.join(str(tmp_path), "s", "ckpt"))
    assert mgr.all_steps() == [2]
    assert np.isfinite(metrics["g_loss"])
    # run.profile_steps: a trace of step 0 to 1
    trace = os.path.join(str(tmp_path), "s", "profile", "steps_0_1.json")
    assert json.load(open(trace))["traceEvents"]


def test_vqgan_resume_is_byte_identical(tmp_path):
    """fit of a tiny ``vqgan512`` (32², codebook 32, one attention block a
    side) with D switched on at step 3: 2 steps, a restore and 2 more end
    byte-identical to 4 unbroken steps; its sample grid has one row pair
    (reconstruct is its only direction)."""
    over = ["model.image_size=32", "data.load_size=36",
            "model.vq_base_features=16", "model.vq_channel_mults=(1,2)",
            "model.vq_embed_dim=8", "model.vq_codebook_size=32",
            "model.vq_attn_resolutions=(16,)", "model.d_layers=2",
            "loss.vq_disc_start=3", "data.batch_size=1",
            "data.synthetic_len=6", "data.num_workers=1", "run.log_every=2",
            "run.ckpt_every=2", "eval.sample_grid_every=4",
            "eval.sample_grid_n=1", f"run.workdir={tmp_path}"]
    cfg = apply_overrides(get_preset("vqgan512"), over)
    fit(apply_overrides(cfg, ["run.name=a"]), max_steps=4, device="cpu")
    fit(apply_overrides(cfg, ["run.name=b"]), max_steps=2, device="cpu")
    fit(apply_overrides(cfg, ["run.name=b"]), max_steps=4, device="cpu")
    ta, ma = _final(str(tmp_path), "a")
    tb, mb = _final(str(tmp_path), "b")
    assert ma["ints"] == mb["ints"] and ma["ints"]["d_opt/count"] == 1
    assert ma["data_state"] == mb["data_state"] == {"t_consumed": 4}
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not differ, differ[:5]
    grid = np.asarray(Image.open(tmp_path / "a" / "samples" /
                                 "step_00000004.png"))
    assert grid.shape == (2 * 32, 32, 3)


@pytest.mark.parametrize("override", [
    "run.steps_per_dispatch=2", "run.n_critic_fuse=true",
    "parallel.multihost=true", "parallel.num_devices=2", "model.kind=munit",
    "run.tensorboard=true", "data.source=tfrecord", "data.source=webdataset",
    "model.kind=gcgan", "model.kind=vaegan", "model.kind=stargan",
    "model.kind=vqgan_prior"])
def test_refused_fields_raise(tmp_path, override):
    cfg = _cfg(str(tmp_path), "r", [override])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit(cfg, max_steps=1, device="cpu")
    assert not os.path.exists(os.path.join(str(tmp_path), "r", "ckpt"))
    assert not torch.are_deterministic_algorithms_enabled()  # put back


def test_build_trainer_kinds_and_debug_nans(tmp_path, monkeypatch):
    cfg = _cfg(str(tmp_path), "n", ["eval.sample_grid_every=0",
                                    "run.debug_nans=true"])
    assert isinstance(build_trainer(cfg, "cpu"), CycleGANTrainer)
    with pytest.raises(ValueError, match="unknown model kind"):
        build_trainer(apply_overrides(cfg, ["model.kind=nope"]), "cpu")
    step = CycleGANTrainer.train_step

    def nan_step(self, state, batch, draws=None):
        state, m = step(self, state, batch, draws)
        return state, dict(m, g_loss=torch.tensor(float("nan")))

    monkeypatch.setattr(CycleGANTrainer, "train_step", nan_step)
    with pytest.raises(FloatingPointError, match="g_loss"):
        fit(cfg, max_steps=2, device="cpu")


def test_cublas_workspace_set_before_cuda_or_refused(monkeypatch):
    """fit sets cuBLAS's fixed workspace before CUDA starts, and refuses a
    process whose CUDA started without it (cuBLAS would keep the workspace
    it already had while torch's deterministic check passes)."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="before CUBLAS_WORKSPACE_CONFIG"):
        fix_cublas_workspace()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    fix_cublas_workspace()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    fix_cublas_workspace()  # set before CUDA started: nothing to refuse
