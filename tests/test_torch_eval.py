"""The port's evaluation path (``uig_torch.eval``: FID, KID, PRDC, IS, the
InceptionV3 and random-conv extractors; ``data.resolve_dataset``; the
best-metric checkpoint retention; bf16 translate) against the JAX package
on the CPU. The same numpy inputs and parameters go into both packages.

Tolerances:
* the numpy metric functions (``frechet_distance``, ``kid_from_features``,
  ``prdc_from_features``, ``inception_score_from_probs``, ``FIDStats``'s
  sums) are the JAX package's code, copied: bit-equal on the same float64
  inputs;
* ``RandomFeatureNet`` (5 fp32 convs, another order of sums): within 1e-5
  of the largest feature, at 32² and 64² (even sides, where flax's SAME
  pads 0 before and 1 after at stride 2);
* ``InceptionV3Features`` (94 fp32 convs and BatchNorms), parameters and
  BatchNorm statistics from a random ``.npz`` with an fc head, at 75²
  (the least side it takes), batch 2: pool3 features and logits within
  1e-4 of the largest;
* the resize to 299² (``jax.image.resize`` bilinear, antialiased when it
  shrinks), from 256², 512² and 64²: within 1e-5 of the largest value, and
  no further from the float64 resize than JAX's (read: JAX 1.8e-6 to
  3.6e-6, the port ~1e-7);
* bf16 translate of a small CycleGAN at 32² and VQGAN at 16² (codes pinned
  to JAX's), against JAX's bf16 apply: both round every layer's output to
  bf16, and already the first conv's outputs differ by one ulp in a tenth
  of their elements (another order of fp32 sums before the rounding; JAX's
  bf16 eval runs XLA's conv and norm, the port K3's plain version). These
  roundings grow through the network as bf16's own distance from fp32
  does, so the yardstick is that distance, from the port's fp32 output
  (which equals JAX's within 1e-5): the two bf16 outputs may be no further
  apart than 1.5 times it at the largest element and 1.25 times in the
  mean (read: CycleGAN 8.50 ulps of the output's largest magnitude against
  7.8, mean 1.2 against 1.2 ulps, uint8 5 steps; VQGAN about 2 ulps); the
  bf16 output must differ from the fp32 one. The 1-2 ulp bar of ROADMAP §1
  item 3 is held per layer group: each group of the CycleGAN generator
  (conv+IN+ReLU, the residual block, the head), fed JAX's bf16 input to
  it, within 2 bf16 ulps of its largest output magnitude (read 0-2);
* retention: the port's ``CheckpointManager`` keeps the step sets and the
  ``latest_step`` of JAX's (orbax) for the same saves, with and without
  metrics, across a new manager on the same directory.

JAX's parameter shapes come from ``jax.eval_shape``; each JAX reference is
one ``jax.jit`` compiled at XLA optimization level 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import uig.eval.fid as jfid
import uig.eval.is_score as jis
import uig.eval.prdc as jprdc
from uig.eval.inception import InceptionV3Features as JaxInception
from uig_torch.config import apply_overrides, get_preset
from uig_torch.convert import flax_from_generator_state
from uig_torch.eval import fid, inception, is_score, prdc

JAX_OPTIONS = {"xla_backend_optimization_level": 0}
BF16_OPTIONS = {**JAX_OPTIONS, "xla_allow_excess_precision": False}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compiled(fn, *args, options=JAX_OPTIONS):
    return jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)


def _tree(flat: dict):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _flat_shapes(module, x) -> dict:
    """flax's variable shapes of ``module`` for input ``x``, by
    ``jax.eval_shape`` (no init is run)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return {k: v.shape for k, v in
            traverse_util.flatten_dict(shapes, sep="/").items()}


def _near(got, want, frac: float, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0 and err <= frac * scale, \
        f"{what}: max|err| {err:.3g} > {frac} of {scale:.3g}"


# ------------------------------------------------------- numpy functions --

def _features(seed, n, d, shift=0.0):
    return np.random.default_rng(seed).standard_normal((n, d)) + shift


def test_metric_functions_bit_equal():
    real, fake = _features(0, 40, 12), _features(1, 36, 12, 0.3)
    st_p, st_j = fid.FIDStats(12), jfid.FIDStats(12)
    for chunk in (real[:15], real[15:]):
        st_p.update(chunk)
        st_j.update(chunk)
    assert st_p.n == st_j.n == 40
    assert np.array_equal(st_p.s, st_j.s) and np.array_equal(st_p.ss, st_j.ss)
    assert np.array_equal(st_p.cov, st_j.cov)
    args = (real.mean(0), np.cov(real, rowvar=False), fake.mean(0),
            np.cov(fake, rowvar=False))
    assert fid.frechet_distance(*args) == jfid.frechet_distance(*args)
    assert fid.frechet_distance(*args) > 0
    kw = dict(n_subsets=7, subset_size=20, seed=3)
    assert fid.kid_from_features(real, fake, **kw) == \
        jfid.kid_from_features(real, fake, **kw)
    for k in (1, 3, 5):
        assert prdc.prdc_from_features(real, fake, k) == \
            jprdc.prdc_from_features(real, fake, k)
    logits = _features(2, 30, 7) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    assert is_score.inception_score_from_probs(probs, 3) == \
        jis.inception_score_from_probs(probs, 3)
    for mod, jmod, call in (
            (prdc, jprdc, lambda m: m.prdc_from_features(real[:3], fake, 5)),
            (is_score, jis,
             lambda m: m.inception_score_from_probs(probs[:2], 3))):
        msgs = []
        for m in (mod, jmod):
            with pytest.raises(ValueError) as e:
                call(m)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_fid_stats_files_cross_load(tmp_path):
    real = _features(4, 9, 6)
    for writer, reader in ((fid.FIDStats, jfid.FIDStats),
                           (jfid.FIDStats, fid.FIDStats)):
        st = writer(6)
        st.update(real)
        path = str(tmp_path / f"{writer.__module__}.npz")
        st.save(path, extractor="random_conv", image_size=16)
        back, name, size = reader.load(path)
        assert (name, size, back.n) == ("random_conv", 16, 9)
        assert np.array_equal(back.s, st.s) and np.array_equal(back.ss, st.ss)
    np.savez(tmp_path / "bad.npz", n=np.int64(1))
    with pytest.raises(ValueError, match="not a uig fid-stats file"):
        fid.FIDStats.load(str(tmp_path / "bad.npz"))


def test_compute_fid_streams_and_refusals():
    """compute_fid/compute_kid over streams equal the functions on the
    gathered features; empty streams and too few images raise."""
    rng = np.random.default_rng(5)
    imgs = [torch.from_numpy(rng.uniform(-1, 1, (3, 8, 8, 3))
                             .astype(np.float32)) for _ in range(4)]
    feat = fid.as_feature_fn(lambda x: x.mean((1, 2)) * 2 + x[:, 0, 0])
    real, fake = fid.collect_features(imgs[:2], imgs[2:], feat)
    st = fid.stream_stats(imgs[:2], feat)
    assert np.array_equal(st.s, real.astype(np.float64).sum(0))
    got = fid.compute_fid(imgs[:2], imgs[2:], feat)
    g = fid.stream_stats(imgs[2:], feat)
    assert got == fid.frechet_distance(st.mean, st.cov, g.mean, g.cov)
    assert fid.compute_fid(None, imgs[2:], feat, real_stats=st) == got
    assert fid.compute_kid(imgs[:2], imgs[2:], feat, n_subsets=3) == \
        fid.kid_from_features(real, fake, n_subsets=3)
    with pytest.raises(ValueError, match="empty image stream"):
        fid.compute_fid([], imgs, feat)
    with pytest.raises(ValueError, match="empty image stream"):
        fid.compute_fid(imgs, [], feat)
    with pytest.raises(ValueError, match="empty image stream"):
        fid.compute_kid(imgs, [], feat)
    with pytest.raises(ValueError, match="empty global image stream"):
        fid.compute_fid(None, imgs, feat, real_stats=fid.FIDStats(3))
    with pytest.raises(ValueError, match="KID needs >=2 real"):
        fid.compute_kid(imgs[:1], imgs, lambda x: feat(x)[:1])


# -------------------------------------------------------------- networks --

@pytest.mark.parametrize("size", [32, 64])
def test_random_feature_net_matches_flax(size):
    """The port's seed-0 net, its parameters carried into flax's
    ``RandomFeatureNet``, at an even side (asymmetric SAME padding)."""
    net = fid.random_feature_net("cpu")
    flat = flax_from_generator_state(net.state_dict())
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)) \
        .astype(np.float32)
    assert set(flat) == set(_flat_shapes(jfid.RandomFeatureNet(),
                                         jnp.asarray(x)))
    ref = _compiled(jfid.RandomFeatureNet().apply, _tree(flat),
                    jnp.asarray(x))
    feat, name = fid.make_feature_fn(
        apply_overrides(get_preset("smoke64"), ["eval.fid_features=random"]),
        "cpu")
    got = feat(torch.from_numpy(x))
    assert name == "random_conv" and got.shape == (2, 768)
    _near(got.numpy(), ref, 1e-5, f"RandomFeatureNet {size}²")


def _inception_npz(path, num_classes: int) -> dict:
    """Random InceptionV3 weights in flax's flat layout, shapes from
    ``jax.eval_shape``: He-scaled kernels, and BatchNorm scales, biases,
    means and variances moved off their init values."""
    shapes = _flat_shapes(JaxInception(num_classes=num_classes),
                          jnp.zeros((1, 75, 75, 3)))
    rng = np.random.default_rng(7)
    flat = {}
    for k, s in sorted(shapes.items()):
        if k.endswith("kernel"):
            v = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[:-1]))
        elif k.endswith("/var"):
            v = rng.uniform(0.5, 1.5, s)
        elif k.endswith("/scale"):
            v = rng.uniform(0.8, 1.2, s)
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(s)
        flat[k] = v.astype(np.float32)
    np.savez(path, **flat)
    return flat


def test_inception_matches_flax(tmp_path):
    """pool3 features and fc logits at 75², batch 2, from one ``.npz``;
    the pool3 network ignores the file's fc keys, as the JAX loader
    does."""
    path = str(tmp_path / "inception.npz")
    flat = _inception_npz(path, 10)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 75, 75, 3)) \
        .astype(np.float32)
    model = JaxInception(num_classes=10)
    fn = jax.jit(lambda v, x: model.apply(
        v, x, capture_intermediates=lambda m, _: m.name == "Mixed_7c",
        mutable=["intermediates"]))
    logits, inter = fn.lower(_tree(flat), jnp.asarray(x)).compile(
        compiler_options=JAX_OPTIONS)(_tree(flat), jnp.asarray(x))
    pool3 = np.asarray(inter["intermediates"]["Mixed_7c"]["__call__"][0]) \
        .mean((1, 2))
    for nc, want in ((0, pool3), (10, logits)):
        _, m = inception.init_inception(path, num_classes=nc, device="cpu")
        with torch.inference_mode():
            got = m(torch.from_numpy(x)).numpy()
        _near(got, want, 1e-4, f"InceptionV3 num_classes={nc}")
    del flat["batch_stats/Mixed_6a/b3x3/bn/var"]
    np.savez(tmp_path / "partial.npz", **flat)
    with pytest.raises(KeyError, match="missing param batch_stats/Mixed_6a"):
        inception.init_inception(str(tmp_path / "partial.npz"), device="cpu")


@pytest.mark.parametrize("size", [256, 512, 64])
def test_resize_to_299_matches_jax(size):
    x = np.random.default_rng(size).uniform(-1, 1, (1, size, size, 3)) \
        .astype(np.float32)
    ref = _compiled(lambda a: jax.image.resize(a, (1, 299, 299, 3),
                                               "bilinear"), jnp.asarray(x))
    got = inception.resize_bilinear(torch.from_numpy(x), 299, 299)
    _near(got.numpy(), ref, 1e-5, f"resize {size}->299")
    w = inception.resize_weights(size, 299).astype(np.float64)
    exact = np.einsum("biwc,wj->bijc",
                      np.einsum("bhwc,hi->biwc", x.astype(np.float64), w), w)
    assert np.abs(got.numpy() - exact).max() <= \
        np.abs(np.asarray(ref) - exact).max()


def test_feature_names_and_inception_resizes():
    """``make_feature_fn``'s names and the untrained InceptionV3's input
    path: a 64² batch goes through the resize to 299²."""
    base = get_preset("smoke64")
    for over, name in ((["eval.fid_features=auto"], "random_conv"),
                       (["eval.fid_features=inception"], "inception_untrained")):
        fn, got = fid.make_feature_fn(apply_overrides(base, over), "cpu")
        assert got == name
    x = torch.zeros(1, 64, 64, 3)
    out = fn(x)
    assert out.shape == (1, 2048)
    with pytest.raises(ValueError, match="unknown fid_features"):
        fid.make_feature_fn(apply_overrides(base, ["eval.fid_features=x"]),
                            "cpu")


# ------------------------------------------------------ resolve_dataset --

def test_resolve_dataset_detects_as_jax(tmp_path, monkeypatch):
    import uig.data.datasets as jds
    import uig_torch.data.datasets as pds

    picked = {}
    for cls in ("FolderDataset", "PackedDataset", "TFRecordImageDataset",
                "WebDatasetImageDataset"):
        monkeypatch.setattr(jds, cls, lambda p, s, c=cls: ("jax", c))
    monkeypatch.setattr(pds, "open_dataset",
                        lambda src, p, s: ("port", src))
    d = tmp_path
    for name in ("tf", "tar", "npy", "img"):
        (d / name).mkdir()
    (d / "tf" / "x.tfrecords").write_bytes(b"")
    (d / "tar" / "x.tar").write_bytes(b"")
    (d / "npy" / "x.npy").write_bytes(b"")
    (d / "odd.bin").write_bytes(b"")
    paths = ["a.npy", "a.tfrecord", "a.tfrecords", "a.tar", "tf", "tar",
             "npy", "img", "odd.bin", "missing"]
    names = {"FolderDataset": "folders", "PackedDataset": "packed",
             "TFRecordImageDataset": "tfrecord",
             "WebDatasetImageDataset": "webdataset"}
    for p in paths:
        outcome = []
        for fn in (jds.resolve_dataset, pds.resolve_dataset):
            try:
                got = fn(str(d / p), 8)
                outcome.append(names.get(got[1], got[1]))
            except (ValueError, FileNotFoundError) as e:
                outcome.append(type(e))
        picked[p] = outcome
        assert outcome[0] == outcome[1], (p, outcome)
    assert picked["tf"][0] == "tfrecord" and picked["img"][0] == "folders"
    assert picked["missing"][0] is FileNotFoundError
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="item 14"):
        pds.resolve_dataset(str(d / "tf"), 8)
    with pytest.raises(ValueError, match="unknown dataset source"):
        pds.resolve_dataset(str(d / "img"), 8, source="nope")


# ------------------------------------------------------------ retention --

def test_retention_keeps_orbax_s_steps(tmp_path):
    """The same saves into JAX's manager (orbax, a tiny pytree) and the
    port's, best-FID with keep 2: the steps kept and the latest after each
    save (saves without metrics, ties, a stale FID, the newest save
    dropped), across a new manager on the same directory as a resumed run
    makes. Keep-last-N alone is ``tests/test_torch_fit.py``'s."""
    from uig.checkpoint import CheckpointManager as JaxManager
    from uig_torch.checkpoint import CheckpointManager

    fids = [None, 5.0, 5.0, 4.0, 6.0, None, 3.0, 3.0]
    for best in ("fid",):
        dj, dp = str(tmp_path / f"j{best}"), str(tmp_path / f"p{best}")
        seen = []
        for part in (fids[:6], fids[6:]):  # a second manager: the resume
            mj = JaxManager(dj, keep=2, best_metric=best)
            mp = CheckpointManager(dp, keep=2, best_metric=best)
            for f in part:
                step = len(seen) + 1
                m = None if f is None else {"fid": f}
                mj.save(step, {"w": jnp.full((2,), step, jnp.float32)},
                        metrics=m)
                mj.wait()
                mp.save(step, {"w": torch.full((2,), float(step))},
                        metrics=m)
                seen.append((list(mj.all_steps()), mj.latest_step()))
                assert (mp.all_steps(), mp.latest_step()) == seen[-1], \
                    (best, step, seen[-1])
            mj.close()
        # the newest save can go while older ones stay
        assert seen[4] == ([1, 3, 4], 4) and seen[-1] == ([1, 6, 7, 8], 8)


# -------------------------------------------------------- bf16 translate --

def _bf16_close(got16, ref16, got32, what: str) -> None:
    """The port's bf16 output ``got16`` against JAX's ``ref16``, with bf16's
    own distance from fp32 (``ref16`` against the port's fp32 output
    ``got32``) as the yardstick (module docstring)."""
    got16, ref16, got32 = (np.asarray(a, np.float64)
                           for a in (got16, ref16, got32))
    d, floor = np.abs(got16 - ref16), np.abs(ref16 - got32)
    assert np.abs(got16 - got32).max() > 0, f"{what}: bf16 equals fp32"
    assert d.max() <= 1.5 * floor.max(), \
        f"{what}: max {d.max():.4g} > 1.5 x bf16's {floor.max():.4g}"
    assert d.mean() <= 1.25 * floor.mean(), \
        f"{what}: mean {d.mean():.4g} > 1.25 x bf16's {floor.mean():.4g}"


def _u8(y) -> np.ndarray:
    y = (np.asarray(y, np.float32) + 1.0) * (255.0 / 2.0)
    return np.clip(np.round(y), 0, 255).astype(np.int16)


def _seeded(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in sorted(shapes.items()):
        if k.endswith("kernel"):
            v = rng.standard_normal(s) / np.sqrt(np.prod(s[:-1]))
        elif k.endswith("scale"):
            v = 1.0 + 0.1 * rng.standard_normal(s)
        elif k.endswith("codebook"):
            v = rng.uniform(-0.5, 0.5, s)
        else:
            v = 0.1 * rng.standard_normal(s)
        flat[k] = v.astype(np.float32)
    return flat


@functools.lru_cache(maxsize=1)
def _cyclegan_bf16_jax():
    """JAX's bf16 eval generator (8 base features, one residual block) at
    32², batch 2, on seeded parameters, in one compile: (input, flat
    parameters, output, the activations after each group of ``_GROUPS``)."""
    from uig.models import ResNetGenerator as JaxGenerator

    gen = JaxGenerator(base_features=8, n_res_blocks=1, dtype=jnp.bfloat16)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    flat = _seeded(_flat_shapes(gen, jnp.asarray(x)), 11)
    taps = tuple(last for _, last in _GROUPS.values())

    def apply(p, a):
        with jax.default_matmul_precision("highest"):
            return gen.apply(p, a.astype(jnp.float32), taps,
                             method=JaxGenerator.with_features)

    y, feats = _compiled(apply, _tree(flat), jnp.asarray(x),
                         options=BF16_OPTIONS)
    assert y.dtype == jnp.bfloat16
    return x, flat, np.asarray(y, np.float32), \
        [np.asarray(f, np.float32) for f in feats]


def _ema(flat: dict) -> dict:
    return {k[len("params/"):].replace("/", "."): torch.from_numpy(v)
            for k, v in flat.items()}


# the generator's layer groups, (first, last) index of its flat layer list:
# conv+IN+ReLU (the stem's conv is F.conv2d, the downsamples K4s's plain
# version, the upsamples a transposed conv), the residual block (two K3
# pairs and the skip) and the 7x7 head with tanh
_GROUPS = {"stem": (0, 2), "down128": (3, 5), "down256": (6, 8),
           "resblock": (9, 9), "up128": (10, 12), "up64": (13, 15),
           "head": (16, 17)}


@pytest.mark.parametrize("group", list(_GROUPS))
def test_bf16_layers_cyclegan_match_jax(group):
    """Each layer group of the port's bf16 eval generator, fed JAX's bf16
    input to that group, within 2 bf16 ulps of the group's largest output
    magnitude of JAX's bf16 output (read: 2, 2, 1, 1, 0.125, 0, 1)."""
    from uig_torch.models.resnet_gen import ResNetGenerator
    from uig_torch.serving import exact_bf16

    x, flat, _, feats = _cyclegan_bf16_jax()
    names = list(_GROUPS)
    k = names.index(group)
    first, last = _GROUPS[group]
    gen = ResNetGenerator(base_features=8, n_res_blocks=1,
                          dtype=torch.bfloat16)
    gen.load_state_dict(_ema(flat))
    h = torch.from_numpy(x) if k == 0 else \
        torch.from_numpy(feats[k - 1]).to(torch.bfloat16)
    with torch.inference_mode(), exact_bf16():
        for i in range(first, last + 1):
            kind = gen.kinds[i]
            h = (torch.relu(h) if kind == "relu" else torch.tanh(h)
                 if kind == "tanh" else getattr(gen, f"layers_{i}")(h))
    assert h.dtype == torch.bfloat16
    ref = feats[k]
    d = np.abs(h.float().numpy() - ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert d.max() <= 2 * ulp, \
        f"{group}: {d.max() / ulp:.3g} bf16 ulps of its largest output"


def test_bf16_translate_cyclegan_matches_jax():
    from uig_torch.train import CycleGANTrainer

    cfg = apply_overrides(get_preset("cyclegan256_dp"), [
        "model.image_size=32", "model.g_base_features=8",
        "model.n_res_blocks=1", "model.d_base_features=8",
        "loss.lambda_lpips=0", "model.compute_dtype=float32",
        "model.eval_dtype=bfloat16"])
    x, flat, ref, _ = _cyclegan_bf16_jax()
    ema = {"a2b": _ema(flat)}
    out = {}
    for dt in ("bfloat16", "float32"):
        tr = CycleGANTrainer(apply_overrides(
            cfg, [f"model.eval_dtype={dt}"]), "cpu")
        assert tr.eval_generator.dtype == getattr(torch, dt)
        out[dt] = tr.translate(ema, torch.from_numpy(x))
        assert out[dt].dtype == getattr(torch, dt)
    got = out["bfloat16"].float().numpy()
    _bf16_close(got, ref, out["float32"].numpy(), "CycleGAN bf16 translate")
    assert np.abs(_u8(got) - _u8(ref)).max() <= 6


def test_bf16_translate_vqgan_matches_jax():
    from uig.models.vqgan import VQGANGenerator as JaxGenerator
    from uig_torch.models.vqgan import pin_codes
    from uig_torch.train import VQGANTrainer

    cfg = apply_overrides(get_preset("vqgan512"), [
        "model.image_size=16", "data.load_size=16",
        "model.vq_base_features=16", "model.vq_channel_mults=(1,2)",
        "model.vq_embed_dim=8", "model.vq_codebook_size=32",
        "model.vq_attn_resolutions=(8,)", "model.d_layers=2",
        "loss.lambda_lpips=0", "model.eval_dtype=bfloat16"])
    m = cfg.model
    gen = JaxGenerator(
        base_features=m.vq_base_features, channel_mults=m.vq_channel_mults,
        embed_dim=m.vq_embed_dim, codebook_size=m.vq_codebook_size,
        attn_resolutions=m.vq_attn_resolutions, dtype=jnp.bfloat16)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    flat = _seeded(_flat_shapes(gen, jnp.asarray(x)), 12)

    def apply(p, a):
        with jax.default_matmul_precision("highest"):
            recon, vq = gen.apply(p, a.astype(jnp.float32))
            return recon, vq.codes, gen.apply(p, vq.codes,
                                              method=JaxGenerator.decode_codes)

    recon, codes, decoded = _compiled(apply, _tree(flat), jnp.asarray(x),
                                      options=BF16_OPTIONS)
    ema = {"a2b": _ema(flat)}
    codes = torch.from_numpy(np.array(codes))
    out = {}
    for dt in ("bfloat16", "float32"):
        tr = VQGANTrainer(apply_overrides(cfg, [f"model.eval_dtype={dt}"]),
                          "cpu")
        with pin_codes(tr.eval_generator.quantizer, codes):
            rec = tr.translate(ema, torch.from_numpy(x), "b2a")
        out[dt] = (rec, tr.decode_codes(ema, codes))
        assert all(t.dtype == getattr(torch, dt) for t in out[dt])
    for i, (ref, what) in enumerate(((recon, "reconstruct"),
                                     (decoded, "decode_codes"))):
        ref = np.asarray(ref, np.float32)
        got = out["bfloat16"][i].float().numpy()
        _bf16_close(got, ref, out["float32"][i].numpy(), f"VQGAN bf16 {what}")
        assert np.abs(_u8(got) - _u8(ref)).max() <= 6
