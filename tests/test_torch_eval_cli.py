"""The port's evaluation commands on the CPU at a tiny size (16² crops of
20² synthetic images, one residual block, batch 2): ``fit`` with the
in-training FID and the best-FID retention, ``eval-fid`` (FID, KID, PRDC,
IS, ``--ref-stats``), ``fid-stats`` and ``sample``, through
``python -m uig_torch.cli``'s ``main``.

References and tolerances:
* the in-training FID equals ``compute_fid`` over the restored EMA's
  translations, bit for bit, and a resumed run writes the same FIDs and
  ends with byte-identical checkpoints;
* ``eval-fid``'s FID, KID and PRDC against the JAX package's: JAX's
  ``RandomFeatureNet`` with the port's seed-0 parameters on the same real
  images and the port's translations, then JAX's numpy functions. The
  features agree within 1e-5 of the largest (``tests/test_torch_eval.py``);
  with 6 samples against 768 feature dimensions the covariances have rank
  5 and ``_sqrtm_psd`` takes roots of near-zero eigenvalues, so a feature
  error can move the FID by more than itself; here it moves FID and KID by
  5.8e-8 and 4.2e-7 of their values, held to rtol 1e-5 (KID's std, ~3e-16,
  to 1e-12), and PRDC (k-NN balls, no distance within rounding of a radius
  here) exactly;
* ``--ref-stats`` from ``fid-stats`` gives the streamed FID bit for bit;
* the Inception Score equals JAX's ``inception_score_from_probs`` over the
  port's logits of the same translations (InceptionV3 with an fc head from
  an ``.npz``; the network itself is held in ``tests/test_torch_eval.py``);
* ``sample`` (a tiny ``vqgan512`` run, codes injected) decodes through the
  EMA decoder as JAX's ``decode_codes`` does with the same parameters and
  codes: uint8 within 1 step.
The port runs single-threaded (PyTorch's multi-threaded CPU conv backward
sums in no fixed order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image
from threadpoolctl import threadpool_limits

import uig.eval.fid as jfid
import uig.eval.is_score as jis
import uig.eval.prdc as jprdc
from uig_torch.checkpoint import CheckpointManager, dump_run_config
from uig_torch.cli.__main__ import main
from uig_torch.config import apply_overrides, config_to_dict, get_preset
from uig_torch.convert import flax_from_generator_state
from uig_torch.data import SyntheticUnpairedDataset
from uig_torch.eval import fid
from uig_torch.eval.inception import init_inception, seeded_inception_flax
from uig_torch.kernels import center_crop_normalize
from uig_torch.train import CycleGANTrainer, VQGANTrainer

TINY = ["model.image_size=16", "model.n_res_blocks=1", "model.d_layers=2",
        "model.g_base_features=8", "model.d_base_features=8",
        "data.batch_size=2", "data.load_size=20", "data.synthetic_len=12",
        "data.num_workers=1", "opt.pool_size=4", "opt.total_steps=100",
        "run.log_every=2", "run.ckpt_every=2", "run.ckpt_keep=2",
        "eval.sample_grid_every=0", "eval.fid_every=2",
        "eval.fid_num_samples=6", "eval.fid_batch_size=4"]
N = 6  # eval images a side
JAX_OPTIONS = {"xla_backend_optimization_level": 0}


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


def _train(tmp, name, steps):
    args = ["train", "--preset", "smoke64", "--device", "cpu",
            "--max-steps", str(steps)]
    for o in TINY + [f"run.workdir={tmp}", f"run.name={name}"]:
        args += ["--set", o]
    assert main(args) == 0


def _lines(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: 6 steps with a FID every 2. Run B: 3 steps, then resumed to
    6."""
    tmp = str(tmp_path_factory.mktemp("evalruns"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            _train(tmp, "a", 6)
            _train(tmp, "b", 3)
            _train(tmp, "b", 6)
    finally:
        torch.set_num_threads(n)
    return tmp


def _cfg(run):
    from uig_torch.config import load_config

    return load_config(os.path.join(run, "config.json"))


def _reals_and_fakes(run, step=None, direction="a2b"):
    """The run's eval images (targets) and the EMA's translations of the
    sources, as eval-fid streams them (all N in one batch)."""
    cfg = _cfg(run)
    tr = CycleGANTrainer(cfg, "cpu")
    state, _, _ = CheckpointManager(os.path.join(run, "ckpt")).restore(
        tr.init_state(0), step)
    syn = SyntheticUnpairedDataset(cfg.data.synthetic_len, 20,
                                   cfg.data.shuffle_seed)
    src, tgt = ((syn.domain_a, syn.domain_b) if direction == "a2b"
                else (syn.domain_b, syn.domain_a))

    def batch(ds):
        return center_crop_normalize(torch.from_numpy(
            np.stack([ds[i] for i in range(N)])), 16)

    return batch(tgt), tr.translate(state.ema, batch(src), direction)


def test_fit_writes_fid_lines_and_keeps_the_best(runs):
    """JAX's cadence: a ``{"fid": ...}`` line after each log line at steps
    2, 4, 6; the value is compute_fid of the EMA at that step; the resumed
    run writes the same FIDs and ends byte-identical; the retention keeps
    the two best FIDs and every save without one (run B's final save at
    step 3)."""
    recs = {r: _lines(os.path.join(runs, r)) for r in ("a", "b")}
    fids = {r: {x["step"]: x["fid"] for x in recs[r] if "fid" in x}
            for r in recs}
    assert [(x["step"], "fid" in x) for x in recs["a"]] == [
        (2, False), (2, True), (4, False), (4, True), (6, False), (6, True)]
    assert fids["a"] == fids["b"] and sorted(fids["a"]) == [2, 4, 6]
    feat, _ = fid.make_feature_fn(_cfg(os.path.join(runs, "a")), "cpu")
    real, fake = _reals_and_fakes(os.path.join(runs, "a"))
    # the in-training FID streams batches of eval.fid_batch_size (4 + 2)
    want = fid.compute_fid([real[:4], real[4:]], [fake[:4], fake[4:]], feat)
    assert fids["a"][6] == want
    ta, ma = CheckpointManager(os.path.join(runs, "a", "ckpt")).read()
    tb, mb = CheckpointManager(os.path.join(runs, "b", "ckpt")).read()
    assert ma["step"] == mb["step"] == 6 and ma["ints"] == mb["ints"]
    assert [k for k in ta if not torch.equal(ta[k], tb[k])] == []
    best = sorted(sorted(fids["a"], key=fids["a"].get)[:2])
    for r, extra in (("a", []), ("b", [3])):
        mgr = CheckpointManager(os.path.join(runs, r, "ckpt"))
        assert mgr.all_steps() == sorted(best + extra)
        assert mgr.metrics(best[-1]) == {"fid": fids["a"][best[-1]]}
    assert CheckpointManager(os.path.join(runs, "b", "ckpt")).metrics(3) is None


def _jax_features(imgs: torch.Tensor) -> np.ndarray:
    """JAX's RandomFeatureNet with the port's seed-0 parameters."""
    flat = flax_from_generator_state(fid.random_feature_net("cpu")
                                     .state_dict())
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    x = jnp.asarray(imgs.float().numpy())
    fn = jax.jit(jfid.RandomFeatureNet().apply).lower(params, x).compile(
        compiler_options=JAX_OPTIONS)
    return np.asarray(fn(params, x))


def _eval(run, capsys, *extra):
    args = ["eval-fid", "--run-dir", run, "--device", "cpu",
            "--num-samples", str(N), "--batch-size", str(N), *extra]
    assert main(args) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return out[-2], json.loads(out[-1])


def test_eval_fid_kid_prdc_match_jax(runs, capsys):
    run = os.path.join(runs, "a")
    line, res = _eval(run, capsys)
    assert line.startswith(f"FID[random_conv] over {N} samples (a2b): ")
    real, fake = _reals_and_fakes(run)
    jfeat = _jax_features(torch.cat([real, fake]))
    jr, jf = jfeat[:N], jfeat[N:]
    sr, sf = jfid.FIDStats(768), jfid.FIDStats(768)
    sr.update(jr)
    sf.update(jf)
    want = jfid.frechet_distance(sr.mean, sr.cov, sf.mean, sf.cov)
    assert res["fid"] == pytest.approx(want, rel=1e-5)
    line, res = _eval(run, capsys, "--kid")
    assert line.startswith(f"KID[random_conv] over {N} samples (a2b): ")
    kid = jfid.kid_from_features(jr, jf)
    assert (res["kid"], res["kid_std"]) == pytest.approx(kid, rel=1e-5,
                                                         abs=1e-12)
    line, res = _eval(run, capsys, "--prdc", "--prdc-k", "2")
    assert line.startswith(f"PRDC[random_conv] over {N} samples (a2b, k=2): ")
    assert res == jprdc.prdc_from_features(jr, jf, k=2)
    # b2a, and the bf16 eval generator, run through the same command
    _, res = _eval(run, capsys, "--direction", "b2a", "--set",
                   "model.eval_dtype=bfloat16")
    assert np.isfinite(res["fid"])


def test_fid_stats_and_ref_stats(runs, tmp_path, capsys):
    """fid-stats over the B eval images (a packed ``.npy``) and
    eval-fid --ref-stats give the FID of the streamed reals bit for bit;
    a stats file of another extractor or size is refused."""
    run = os.path.join(runs, "a")
    cfg = _cfg(run)
    syn = SyntheticUnpairedDataset(cfg.data.synthetic_len, 20,
                                   cfg.data.shuffle_seed)
    packed = str(tmp_path / "b.npy")
    from uig_torch.data import PackedDataset

    PackedDataset.pack(syn.domain_b, packed)
    stats = str(tmp_path / "b_stats.npz")
    assert main(["fid-stats", "--data-dir", packed, "--output", stats,
                 "--image-size", "16", "--num-samples", str(N),
                 "--batch-size", str(N), "--load-size", "20",
                 "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"stats": stats, "extractor": "random_conv"}
    _, streamed = _eval(run, capsys)
    line, res = _eval(run, capsys, "--ref-stats", stats)
    assert "vs precomputed real stats (n=6)" in line
    assert res == streamed
    st, _, _ = fid.FIDStats.load(stats)
    for name, size, match in (("inception_untrained", 16, "extractor"),
                              ("random_conv", 32, "image_size")):
        bad = str(tmp_path / f"{name}{size}.npz")
        st.save(bad, extractor=name, image_size=size)
        with pytest.raises(ValueError, match=match):
            _eval(run, capsys, "--ref-stats", bad)
    with pytest.raises(ValueError, match="FID-only"):
        _eval(run, capsys, "--ref-stats", stats, "--kid")


def test_inception_score(runs, tmp_path, capsys):
    """IS of 2 translations (2 splits) through an InceptionV3 with a
    10-class fc head from an ``.npz``; without the head, or without
    weights, it is refused."""
    run = os.path.join(runs, "a")
    w = str(tmp_path / "inc_fc.npz")
    np.savez(w, **seeded_inception_flax(num_classes=10, seed=3))
    args = ["--inception-score", "--is-splits", "2", "--num-samples", "2",
            "--set", f"eval.inception_weights={w}"]
    line, res = _eval(run, capsys, *args)
    assert line.startswith("IS[inception_fc10] over 2 samples (a2b, 2 "
                           "splits): ")
    _, fake = _reals_and_fakes(run)
    apply_fn, model = init_inception(w, num_classes=10, device="cpu")
    with torch.inference_mode():
        lg = apply_fn(model, fake[:2]).numpy().astype(np.float64)
    lg -= lg.max(1, keepdims=True)
    probs = np.exp(lg) / np.exp(lg).sum(1, keepdims=True)
    assert (res["is"], res["is_std"]) == jis.inception_score_from_probs(
        probs, 2)
    with pytest.raises(ValueError, match="needs eval.inception_weights"):
        _eval(run, capsys, "--inception-score")
    # the head is looked for before any weight is read
    np.savez(str(tmp_path / "nofc.npz"), x=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="no fc head"):
        _eval(run, capsys, "--inception-score", "--set",
              f"eval.inception_weights={tmp_path / 'nofc.npz'}")


def test_eval_refusals(runs, capsys):
    run = os.path.join(runs, "a")
    with pytest.raises(NotImplementedError, match="item 10"):
        _eval(run, capsys, "--target-domain", "1")
    with pytest.raises(ValueError, match="deterministic per input"):
        _eval(run, capsys, "--diversity", "2")
    with pytest.raises(ValueError, match="no unconditional sampling path"):
        main(["sample", "--run-dir", run, "--output-dir", run + "/s",
              "--device", "cpu"])


VQ = ["model.image_size=16", "data.load_size=16",
      "model.vq_base_features=16", "model.vq_channel_mults=(1,2)",
      "model.vq_embed_dim=8", "model.vq_codebook_size=32",
      "model.vq_attn_resolutions=(8,)", "model.d_layers=2",
      "loss.lambda_lpips=0", "model.compute_dtype=float32"]


def test_sample_vqgan_matches_jax_decode(tmp_path, capsys, monkeypatch):
    """``sample`` on a vqgan run (its step-0 checkpoint): the injected codes
    decoded by the EMA decoder, against JAX's ``decode_codes`` with the
    same parameters; the JAX package's warning; vaegan is refused with its
    ROADMAP item."""
    from uig.models.vqgan import VQGANGenerator as JaxGenerator
    import uig_torch.cli.sample as sample_mod

    cfg = apply_overrides(get_preset("vqgan512"),
                          VQ + [f"run.workdir={tmp_path}"])
    run = str(tmp_path / "vq")
    dump_run_config(config_to_dict(cfg), run)
    state = VQGANTrainer(cfg, "cpu").init_state(0)
    CheckpointManager(os.path.join(run, "ckpt")).save(0, state)
    codes = torch.from_numpy(np.random.default_rng(2).integers(
        0, 32, (3, 8, 8)))
    monkeypatch.setattr(sample_mod, "draw_codes",
                        lambda n, hw, k, seed: codes)
    with pytest.warns(UserWarning, match="UNIFORM-RANDOM codes"):
        assert main(["sample", "--run-dir", run, "--output-dir",
                     str(tmp_path / "out"), "-n", "3", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip())["sampled"] == 3
    got = np.stack([np.asarray(Image.open(tmp_path / "out" / f"{i:05d}.png"))
                    for i in range(3)]).astype(np.int16)
    m = cfg.model
    gen = JaxGenerator(
        base_features=m.vq_base_features, channel_mults=m.vq_channel_mults,
        embed_dim=m.vq_embed_dim, codebook_size=m.vq_codebook_size,
        attn_resolutions=m.vq_attn_resolutions)
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in
         flax_from_generator_state(state.ema["a2b"]).items()})
    c = jnp.asarray(codes.numpy().astype(np.int32))

    def decode(p, c):
        with jax.default_matmul_precision("highest"):
            return gen.apply(p, c, method=JaxGenerator.decode_codes)

    ref = jax.jit(decode).lower(params, c).compile(
        compiler_options=JAX_OPTIONS)(params, c)
    want = np.clip(np.round((np.asarray(ref) + 1.0) * 127.5), 0, 255)
    assert np.abs(got - want).max() <= 1
    vae = apply_overrides(cfg, ["model.kind=vaegan"])
    dump_run_config(config_to_dict(vae), str(tmp_path / "vae"))
    with pytest.raises(NotImplementedError, match="item 8"):
        main(["sample", "--run-dir", str(tmp_path / "vae"), "--output-dir",
              str(tmp_path / "o2"), "--device", "cpu"])
