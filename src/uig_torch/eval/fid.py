"""FID and KID, in PyTorch: the port of the JAX package's ``eval/fid.py``.

Features come from a network on the device (``make_feature_fn``: the
InceptionV3 pool3 of ``eval/inception.py``, or ``RandomFeatureNet``); the
mean and covariance accumulate on the host in float64 as raw sums
(``FIDStats``), and the Fréchet distance and KID are the JAX package's
numpy code, copied. The networks run in fp32 under ``serving.exact_fp32``
(library convs without TF32, deterministic cuDNN), so a metric repeats bit
for bit on one card.

Weights: without ``eval.inception_weights`` the extractor is drawn from seed
0 with numpy by flax's default initializers (lecun-normal conv kernels, zero
biases; BatchNorm scale 1, bias 0, mean 0, variance 1), as
``convert.seeded_flax`` draws LPIPS's VGG. torch cannot reproduce
``jax.random``'s bits, so a seed-0 extractor of the port differs from the
JAX package's and their FIDs are not comparable; with the same ``.npz``
file both packages compute the same features. ``FIDStats`` files are the
JAX package's format: either package loads the other's.

One process only: the JAX package's cross-process gathers are not ported
(ROADMAP §1 item 12, multi-GPU data parallel).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from uig_torch.convert import generator_state_from_flax, seeded_flax
from uig_torch.runtime import resolve_device
from uig_torch.serving import exact_fp32


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax's ``"SAME"`` padding of one spatial axis: (before, after). An
    even side at stride 2 pads 0 before and 1 after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_hwio(x: torch.Tensor, kernel: torch.Tensor, bias, stride=(1, 1),
              padding="SAME") -> torch.Tensor:
    """flax ``nn.Conv`` on NCHW ``x`` with an HWIO ``kernel``, padding
    ``"SAME"`` (asymmetric where flax's is) or ``"VALID"``."""
    kh, kw = kernel.shape[:2]
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(x.shape[2], kh, stride[0]),
                          same_pads(x.shape[3], kw, stride[1]))
        if t == b and l == r:
            pad = (t, l)
        else:
            x, pad = F.pad(x, (l, r, t, b)), (0, 0)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"unknown padding {padding!r}")
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, stride, pad)


def _refuse_multiprocess() -> None:
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "FID/KID/PRDC/IS across processes (the JAX package's gathers) are "
            "not ported yet (ROADMAP §1 item 12, multi-GPU data parallel)")


class _Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), strides=(2, 2))``: HWIO kernel and
    bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))


class RandomFeatureNet(nn.Module):
    """Deterministic random-conv feature extractor: 5 stride-2 3x3 SAME
    convs with LeakyReLU 0.2, then the global average -> (B, 8 * width)
    features. NHWC in; the parameters keep flax's names (``conv0`` ...)."""

    def __init__(self, width: int = 96):
        super().__init__()
        cin = 3
        for i, mult in enumerate((1, 2, 4, 8, 8)):
            setattr(self, f"conv{i}", _Conv(cin, width * mult))
            cin = width * mult

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(torch.float32).permute(0, 3, 1, 2)
        for i in range(5):
            c = getattr(self, f"conv{i}")
            h = F.leaky_relu(conv_hwio(h, c.kernel, c.bias, (2, 2)), 0.2)
        return h.mean((2, 3))


@functools.lru_cache(maxsize=1)
def _seed0_flat() -> dict:
    """The seed-0 weights, drawn once a process (evaluations in one process,
    such as ``fit``'s, share them)."""
    return seeded_flax(RandomFeatureNet(), 0)


def random_feature_net(device="cuda") -> RandomFeatureNet:
    """``RandomFeatureNet`` drawn from seed 0 (``convert.seeded_flax``)."""
    net = RandomFeatureNet()
    net.load_state_dict(generator_state_from_flax(_seed0_flat(), net))
    return net.to(resolve_device(device)).eval().requires_grad_(False)


def make_feature_fn(cfg, device="cuda") -> tuple[Callable, str]:
    """(images -> features function, extractor name), with the JAX
    package's names: ``inception_pool3`` (``eval.inception_weights``),
    ``inception_untrained`` or ``random_conv``. The function takes NHWC
    images in [-1, 1] on the device and gives fp32 (B, D) features there."""
    kind = cfg.eval.fid_features
    weights = cfg.eval.inception_weights or None
    if kind == "auto":
        kind = "inception" if weights else "random"
    if kind == "inception":
        from uig_torch.eval.inception import init_inception

        apply_fn, model = init_inception(weights, device=device)
        name = "inception_pool3" if weights else "inception_untrained"
        return as_feature_fn(lambda x: apply_fn(model, x)), name
    if kind == "random":
        return as_feature_fn(random_feature_net(device)), "random_conv"
    raise ValueError(f"unknown fid_features {kind!r}")


def as_feature_fn(fn: Callable) -> Callable:
    """``fn`` run without autograd under ``serving.exact_fp32``."""

    def features(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), exact_fp32():
            return fn(x)

    return features


class FIDStats:
    """Streaming mean/cov accumulator (host, float64)."""

    def __init__(self, dim: int):
        self.n = 0
        self.s = np.zeros((dim,), np.float64)
        self.ss = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.s += f.sum(0)
        self.ss += f.T @ f

    def save(self, path: str, extractor: str = "", image_size: int = 0):
        """The raw sums (n, Σx, Σxxᵀ) and the extractor's name and crop size,
        so that a reuse under other settings is refused."""
        np.savez(path, n=np.int64(self.n), s=self.s, ss=self.ss,
                 extractor=np.str_(extractor), image_size=np.int64(image_size))

    @classmethod
    def load(cls, path: str) -> tuple["FIDStats", str, int]:
        """Returns (stats, extractor_name, image_size)."""
        z = np.load(path, allow_pickle=False)
        for key in ("n", "s", "ss", "extractor", "image_size"):
            if key not in z:
                raise ValueError(
                    f"{path} is not a uig fid-stats file (missing {key!r})")
        st = cls(int(z["s"].shape[0]))
        st.n = int(z["n"])
        st.s = np.asarray(z["s"], np.float64)
        st.ss = np.asarray(z["ss"], np.float64)
        return st, str(z["extractor"]), int(z["image_size"])

    @property
    def mean(self) -> np.ndarray:
        return self.s / max(self.n, 1)

    @property
    def cov(self) -> np.ndarray:
        if self.n < 2:
            return np.zeros_like(self.ss)
        m = self.mean
        return (self.ss - self.n * np.outer(m, m)) / (self.n - 1)


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh(a)
    w = np.clip(w, 0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """d² = |μ₁−μ₂|² + Tr(Σ₁+Σ₂−2·sqrtm(Σ₁Σ₂)), scipy-free."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64) + eps * np.eye(len(mu1))
    cov2 = np.asarray(cov2, np.float64) + eps * np.eye(len(mu2))
    s1 = _sqrtm_psd(cov1)
    middle = s1 @ cov2 @ s1  # symmetric PSD; same spectrum as cov1 @ cov2
    w = np.clip(np.linalg.eigvalsh(middle), 0, None)
    tr_sqrt = np.sqrt(w).sum()
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt)


def kid_from_features(real: np.ndarray, fake: np.ndarray,
                      n_subsets: int = 100, subset_size: int = 100,
                      seed: int = 0) -> tuple[float, float]:
    """Kernel Inception Distance: the unbiased MMD² with the polynomial
    kernel k(x,y) = (xᵀy/d + 1)³, averaged over random subsets. Returns
    (mean, std) over subsets."""
    rng = np.random.default_rng(seed)
    real = np.asarray(real, np.float64)
    fake = np.asarray(fake, np.float64)
    d = real.shape[1]
    m = min(subset_size, real.shape[0], fake.shape[0])
    vals = []
    for _ in range(n_subsets):
        x = real[rng.choice(real.shape[0], m, replace=False)]
        y = fake[rng.choice(fake.shape[0], m, replace=False)]
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        np.fill_diagonal(kxx, 0.0)
        np.fill_diagonal(kyy, 0.0)
        mmd = (kxx.sum() + kyy.sum()) / (m * (m - 1)) - 2.0 * kxy.mean()
        vals.append(mmd)
    return float(np.mean(vals)), float(np.std(vals))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def collect_features(real_batches: Iterable, fake_batches: Iterable,
                     feature_fn: Callable) -> tuple[np.ndarray, np.ndarray]:
    """(real, fake) feature matrices of two image streams: the front half
    of KID and PRDC."""
    _refuse_multiprocess()
    feats = []
    for batches in (real_batches, fake_batches):
        fs = [_host(feature_fn(b)) for b in batches]
        if not fs:
            raise ValueError("empty image stream")
        feats.append(np.concatenate(fs, 0))
    return feats[0], feats[1]


def compute_kid(real_batches: Iterable, fake_batches: Iterable,
                feature_fn: Callable, **kw) -> tuple[float, float]:
    """KID between two image streams (the interface of compute_fid)."""
    real, fake = collect_features(real_batches, fake_batches, feature_fn)
    for name, f in zip(("real", "fake"), (real, fake)):
        if f.shape[0] < 2:  # m<2 → 0/0 in the unbiased MMD estimator
            raise ValueError(
                f"KID needs >=2 {name} images globally, got {f.shape[0]}")
    return kid_from_features(real, fake, **kw)


def stream_stats(batches: Iterable, feature_fn: Callable) -> FIDStats:
    """FIDStats of one image stream."""
    _refuse_multiprocess()
    st = None
    for b in batches:
        f = _host(feature_fn(b))
        if st is None:
            st = FIDStats(f.shape[-1])
        st.update(f)
    if st is None:
        raise ValueError("empty image stream for FID")
    return st


def compute_fid(real_batches: Iterable | None, fake_batches: Iterable,
                feature_fn: Callable,
                real_stats: FIDStats | None = None) -> float:
    """FID between two streams of (B, H, W, 3) images in [-1, 1] on the
    device. ``real_stats``: precomputed statistics of the real domain
    (``fid-stats``, ``FIDStats.load``); the real stream is then skipped."""
    if real_stats is not None:
        r = real_stats
    elif real_batches is not None:
        r = stream_stats(real_batches, feature_fn)
    else:
        raise ValueError("need real_batches or real_stats")
    g = stream_stats(fake_batches, feature_fn)
    if r.n == 0:  # a --ref-stats file of no images
        raise ValueError("empty global image stream for FID")
    return frechet_distance(r.mean, r.cov, g.mean, g.cov)


def eval_batches(ds, n: int, batch_size: int, crop: int,
                 device) -> Iterator[torch.Tensor]:
    """The first ``n`` images of ``ds`` in batches of ``batch_size``,
    center-cropped to ``crop`` and normalized to [-1, 1] on ``device``."""
    from uig_torch.kernels.augment import center_crop_normalize

    for s in range(0, n, batch_size):
        raw = np.stack([ds[i] for i in range(s, min(s + batch_size, n))])
        yield center_crop_normalize(torch.from_numpy(raw).to(device), crop)


def translation_streams(cfg, trainer, state, n: int, batch_size: int,
                        direction: str = "a2b") -> tuple[int, Iterator,
                                                         Iterator]:
    """(n, real batches, fake batches) of an evaluation: up to ``n`` eval
    images of the target domain, and the EMA's ``direction`` translations
    of as many of the source domain's, in batches of ``batch_size``. Both
    ``eval-fid`` and the in-training FID read these streams."""
    from uig_torch.data import eval_datasets

    ds_a, ds_b = eval_datasets(cfg)
    src, tgt = (ds_a, ds_b) if direction == "a2b" else (ds_b, ds_a)
    n = min(n, len(src), len(tgt))
    crop, dev = cfg.model.image_size, trainer.device
    fake = (trainer.translate(state.ema, x, direction)
            for x in eval_batches(src, n, batch_size, crop, dev))
    return n, eval_batches(tgt, n, batch_size, crop, dev), fake
