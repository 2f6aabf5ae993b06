"""The training loop: the port of the JAX package's ``train/loop.py``.

``fit`` composes config -> trainer -> input pipeline -> hot loop
(``train_step``) -> metrics (``metrics.jsonl``) -> in-training FID ->
checkpoints -> sample grids -> profiler window, on one device. With
``eval.fid_every`` the FID of the EMA's a2b translations against the B eval
images (``_inline_fid``) is written as a ``{"fid": ...}`` line every
``fid_every`` steps, and each cadence save carries the last one for the
best-FID retention (``checkpoint/ckpt.py``). It resumes from the newest
checkpoint under ``<run.workdir>/<run.name>/ckpt`` with the pipeline's
cursor, so a resumed run continues bit for bit; SIGTERM or SIGINT ends the
loop after the step in flight and saves once more.

Exact resume on the card needs the card to repeat itself from process to
process: ``fit`` sets ``CUBLAS_WORKSPACE_CONFIG`` (unless the caller did)
before its first CUDA call, refuses a process whose CUDA started without it
(``fix_cublas_workspace``), and runs under
``torch.use_deterministic_algorithms(True)``; the trainers pin cuDNN's
algorithms (``serving.exact_fp32``/``exact_bf16``) and the CUDA kernels sum
in a fixed order.
"""

from __future__ import annotations

import math
import os
import signal

import numpy as np
import torch

from uig_torch.checkpoint import CheckpointManager, dump_run_config
from uig_torch.config import Config, config_to_dict
from uig_torch.data import eval_datasets, make_input_pipeline
from uig_torch.data.datasets import refuse_unported_source
from uig_torch.kernels.augment import center_crop_normalize, denormalize_to_u8
from uig_torch.metrics import MetricsWriter, StepTimer
from uig_torch.runtime import resolve_device

# model kinds the JAX package trains and the port does not yet, with the
# ROADMAP §1 item that ports each
UNPORTED_KINDS = {
    "gcgan": "item 9, the other ResNet-generator trainers",
    "unit": "item 10, other families",
    "munit": "item 10, other families",
    "stargan": "item 10, other families",
    "starganv2": "item 10, other families",
    "nicegan": "item 10, other families",
    "ugatit": "item 10, other families",
    "vaegan": "item 8, VAE-GAN",
    "vqgan_prior": "item 11, the VQGAN latent prior",
}

# cuBLAS's fixed workspace, which torch's deterministic mode requires
CUBLAS_WORKSPACE = ":4096:8"


def fix_cublas_workspace() -> None:
    """Give cuBLAS the fixed workspace that torch's deterministic mode
    requires. cuBLAS reads the setting once, when the process makes its
    first handle, while torch's check reads it again at each call; so a
    process whose CUDA started without it would pass the check on the
    workspace it already had. Refuse that: a caller that uses CUDA before
    ``fit`` in the same process sets the variable before its first CUDA
    call."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        return
    if torch.cuda.is_initialized():
        raise RuntimeError(
            "fit: CUDA started in this process before CUBLAS_WORKSPACE_CONFIG "
            "was set, so cuBLAS keeps a workspace that an exact resume cannot "
            f"rely on; set CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE} before "
            "the first CUDA call")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE


def build_trainer(cfg: Config, device="cuda"):
    """The trainer of ``cfg.model.kind``: ``cyclegan``, ``vqgan``, ``cut``
    (CUT and FastCUT) or ``dclgan``."""
    kind = cfg.model.kind
    if kind == "cyclegan":
        from uig_torch.train.cyclegan import CycleGANTrainer

        return CycleGANTrainer(cfg, device)
    if kind == "vqgan":
        from uig_torch.train.vqgan import VQGANTrainer

        return VQGANTrainer(cfg, device)
    if kind == "cut":
        from uig_torch.train.cut import CUTTrainer

        return CUTTrainer(cfg, device)
    if kind == "dclgan":
        from uig_torch.train.dclgan import DCLGANTrainer

        return DCLGANTrainer(cfg, device)
    if kind in UNPORTED_KINDS:
        raise NotImplementedError(
            f"model.kind={kind!r} is not ported yet (ROADMAP §1 "
            f"{UNPORTED_KINDS[kind]})")
    raise ValueError(f"unknown model kind {kind!r}")


def refuse_unported(cfg: Config, device: torch.device) -> None:
    """Raise NotImplementedError for every field ``fit`` cannot honour
    (``run.tensorboard`` is refused by ``MetricsWriter``, the model kinds by
    ``build_trainer``)."""
    run, par = cfg.run, cfg.parallel
    unported = {
        "run.steps_per_dispatch > 1 (ROADMAP §1 item 13, dispatch "
        "amortization)": run.steps_per_dispatch > 1,
        "run.n_critic_fuse (ROADMAP §1 item 13, dispatch amortization)":
            run.n_critic_fuse,
        "parallel.multihost (ROADMAP §1 item 12, multi-GPU data parallel)":
            par.multihost,
        "parallel.num_devices > 1 (ROADMAP §1 item 12, multi-GPU data "
        "parallel)": par.num_devices > 1,
        "parallel.num_devices=0 (all cards) with more than one card visible "
        "(ROADMAP §1 item 12, multi-GPU data parallel; set "
        "parallel.num_devices=1)":
            par.num_devices == 0 and device.type == "cuda"
            and torch.cuda.device_count() > 1,
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"fit: {what} is not ported yet; "
                                      "set it off")
    refuse_unported_source(cfg.data.source)
    if run.log_every < 1:
        raise ValueError(f"run.log_every must be >= 1, got {run.log_every}")


def fit(cfg: Config, max_steps: int | None = None, device="cuda") -> dict:
    """Train to ``opt.total_steps`` (or ``max_steps``) on ``device`` (the
    card unless ``"cpu"``) and return the last step's metrics. Resumes from
    the newest checkpoint of the run's workdir.

    ``run.debug_nans`` raises FloatingPointError on a non-finite metric at
    the log cadence. ``run.check_tracer_leaks`` is a JAX tracing check with
    no torch meaning: eager PyTorch has no tracers to leak, so the field
    changes nothing here. Refused with NotImplementedError: see
    ``refuse_unported``. On the card, a caller that has used CUDA in this
    process already must have set ``CUBLAS_WORKSPACE_CONFIG`` before that
    (``fix_cublas_workspace``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":  # before the first CUDA call
        fix_cublas_workspace()
    refuse_unported(cfg, dev)
    workdir = os.path.join(cfg.run.workdir, cfg.run.name)
    os.makedirs(workdir, exist_ok=True)
    dump_run_config(config_to_dict(cfg), workdir)
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"),
                             keep=cfg.run.ckpt_keep,
                             best_metric="fid" if cfg.eval.fid_every else None)
    writer = MetricsWriter(workdir, tensorboard=cfg.run.tensorboard)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    pipe = profiler = None
    old_handlers = {}
    stop = {"flag": False}

    def _handle(sig, frame):
        stop["flag"] = True

    try:
        trainer = build_trainer(cfg, dev)
        state = trainer.init_state(cfg.run.seed)
        pipe = make_input_pipeline(cfg, dev, start=False)
        if ckpt.latest_step() is not None:
            state, data_state, _ = ckpt.restore(state)
            if data_state:
                pipe.load_state_dict(data_state)
        pipe.start()
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _handle)

        total = max_steps if max_steps is not None else cfg.opt.total_steps
        timer = StepTimer()
        metrics = {}
        last_fid = feature = None
        step = int(state.step)
        last_saved = step if ckpt.latest_step() == step else -1
        prof_start, prof_stop = cfg.run.profile_steps
        while step < total and not stop["flag"]:
            if prof_stop > prof_start and step == prof_start and profiler is None:
                profiler = _start_profile(dev)
            timer.data_start()
            batch = next(pipe)
            timer.data_stop()
            state, metrics = trainer.train_step(state, batch)
            step += 1
            timer.step_done(cfg.data.batch_size)
            if profiler is not None and step >= prof_stop:
                _stop_profile(profiler, dev, workdir, prof_start, prof_stop)
                profiler = None
            if step % cfg.run.log_every == 0:
                host_m = {k: float(v) for k, v in metrics.items()}
                if cfg.run.debug_nans:
                    bad = sorted(k for k, v in host_m.items()
                                 if not math.isfinite(v))
                    if bad:
                        raise FloatingPointError(
                            f"run.debug_nans: non-finite {bad} at step {step}")
                host_m["images_per_sec_chip"] = timer.throughput  # 1 device
                host_m["input_stall_pct"] = timer.stall_pct
                host_m.update(_hbm_stats(dev))
                writer.write(step, host_m)
                timer.reset()
            if cfg.eval.fid_every and step % cfg.eval.fid_every == 0:
                if feature is None:  # one extractor for the run
                    from uig_torch.eval.fid import make_feature_fn

                    feature, _ = make_feature_fn(cfg, dev)
                last_fid = _inline_fid(cfg, trainer, state, feature)
                writer.write(step, {"fid": last_fid})
            if cfg.run.ckpt_every and step % cfg.run.ckpt_every == 0:
                ckpt.save(step, state, data_state=pipe.state_dict(),
                          metrics=None if last_fid is None
                          else {"fid": last_fid})
                last_saved = step
            if (cfg.eval.sample_grid_every
                    and step % cfg.eval.sample_grid_every == 0):
                _write_sample_grid(cfg, trainer, state, workdir, step)
        # the final (or preemption) save
        if last_saved != step:
            ckpt.save(step, state, data_state=pipe.state_dict())
        ckpt.wait()
    finally:
        if profiler is not None:
            _stop_profile(profiler, dev, workdir, prof_start, prof_stop)
        if pipe is not None:
            pipe.stop()
        writer.close()
        ckpt.close()
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        torch.use_deterministic_algorithms(deterministic)
    return {k: float(v) for k, v in metrics.items()}


def _start_profile(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, dev: torch.device, workdir: str, start: int,
                  stop: int) -> None:
    """End the ``run.profile_steps`` window and write its Chrome trace to
    ``<workdir>/profile/``."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.stop()
    out = os.path.join(workdir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"steps_{start}_{stop}.json"))


def _hbm_stats(dev: torch.device) -> dict:
    """Device memory in use and its peak, from the caching allocator; none
    on the CPU."""
    if dev.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(dev)
    return {"hbm_gb_in_use": s.get("allocated_bytes.all.current", 0) / 2**30,
            "hbm_gb_peak": s.get("allocated_bytes.all.peak", 0) / 2**30}


def _inline_fid(cfg, trainer, state, feature_fn) -> float:
    """In-training FID (a2b) on up to ``eval.fid_num_samples`` eval images,
    in batches of ``eval.fid_batch_size``: the B images against the EMA's
    translations of the A images, through ``feature_fn``
    (``make_feature_fn`` of the config); the streams of ``eval-fid``. One
    process: the JAX package's per-host shards are not ported (ROADMAP §1
    item 12)."""
    from uig_torch.eval.fid import compute_fid, translation_streams

    _, real, fake = translation_streams(cfg, trainer, state,
                                        cfg.eval.fid_num_samples,
                                        cfg.eval.fid_batch_size)
    return compute_fid(real, fake, feature_fn)


def _write_sample_grid(cfg, trainer, state, workdir: str, step: int,
                       n: int | None = None) -> None:
    """The EMA's translations of the first ``eval.sample_grid_n`` eval
    images, A->B (and B->A where the trainer has it), as one PNG grid:
    ``<workdir>/samples/step_<step>.png``."""
    from PIL import Image

    n = n or cfg.eval.sample_grid_n
    crop = cfg.model.image_size
    ds_a, ds_b = eval_datasets(cfg)

    def batch(ds):
        raw = torch.from_numpy(np.stack([ds[i] for i in range(n)]))
        return center_crop_normalize(raw.to(trainer.device), crop)

    xa = batch(ds_a)
    pairs = [(xa, trainer.translate(state.ema, xa, "a2b"))]
    if "b2a" in getattr(trainer, "directions", ("a2b", "b2a")):
        xb = batch(ds_b)
        pairs.append((xb, trainer.translate(state.ema, xb, "b2a")))
    rows = []
    for x, y in pairs:
        src = denormalize_to_u8(x).cpu().numpy()
        dst = denormalize_to_u8(y).cpu().numpy()
        rows.append(np.concatenate([np.concatenate(list(src), 1),
                                    np.concatenate(list(dst), 1)], 0))
    out_dir = os.path.join(workdir, "samples")
    os.makedirs(out_dir, exist_ok=True)
    Image.fromarray(np.concatenate(rows, 0)).save(
        os.path.join(out_dir, f"step_{step:08d}.png"))
