"""``python -m uig_torch.cli fid-stats``: precompute a dataset's FID
reference statistics once and reuse them across evals (``eval-fid
--ref-stats``). The ``.npz`` holds the raw sums (n, Σx, Σxxᵀ) in float64
with the extractor's name and the crop size, in the JAX package's format,
so a mismatched reuse is refused. The port of its ``cli/fid_stats.py``."""

from __future__ import annotations


def run_fid_stats(data_dir: str, output: str, image_size: int,
                  num_samples: int | None = None, batch_size: int = 16,
                  source: str = "auto", load_size: int | None = None,
                  overrides=(), device: str = "cuda") -> str:
    """Stream ``data_dir`` (folder or packed ``.npy``) through the
    configured feature extractor on ``device`` and save its FID statistics
    to ``output``. Returns the extractor's name."""
    from uig_torch.config import Config, apply_overrides
    from uig_torch.data import resolve_dataset
    from uig_torch.eval.fid import eval_batches, make_feature_fn, stream_stats
    from uig_torch.runtime import resolve_device

    cfg = apply_overrides(Config(), list(overrides))
    ds = resolve_dataset(data_dir, load_size or cfg.data.load_size,
                         source=source)
    n = min(num_samples or len(ds), len(ds))
    if n < 2:
        raise ValueError(f"FID statistics need >=2 images, {data_dir} "
                         f"yields {n}")
    dev = resolve_device(device)
    feature_fn, name = make_feature_fn(cfg, dev)
    st = stream_stats(eval_batches(ds, n, batch_size, image_size, dev),
                      feature_fn)
    st.save(output, extractor=name, image_size=image_size)
    print(f"wrote {output}: n={st.n} dim={st.s.shape[0]} "
          f"extractor={name} image_size={image_size}")
    return name
