"""The port's datasets and input pipeline (``uig_torch.data``, on the CPU
device) against the JAX package's (``uig.data``, numpy only:
``mesh=None``).

All comparisons are byte equality of uint8 images: the synthetic domains
draw from the same ``default_rng`` streams with the same float32
arithmetic, the folders decode with PIL (JAX's ``decoder="pil"``), the
packed files are the same bytes, and the batch stream is the same pure
function of (seed, batch counter)."""

import numpy as np
import pytest
import torch
from uig.config import apply_overrides as jax_overrides
from uig.config import get_preset as jax_preset
from uig.data import datasets as jds
from uig.data import eval_datasets as jax_eval_datasets
from uig.data.pipeline import UnpairedPipeline as JaxPipeline
from uig_torch.config import apply_overrides, get_preset
from uig_torch.data import (FolderDataset, PackedDataset, UnpairedPipeline,
                            eval_datasets, make_input_pipeline)
from uig_torch.data import datasets as tds

N = 5          # images a domain: batch 2 crosses an epoch at position 5
LOAD = 12
BATCH = 2
SEED = 3


@pytest.mark.parametrize("kind", ["blobs", "stripes", "checker", "rings"])
def test_synthetic_domain_is_byte_equal(kind):
    port = tds._SyntheticDomain(kind, 4, 24, 7)
    ref = jds._SyntheticDomain(kind, 4, 24, 7)
    for i in range(4):
        np.testing.assert_array_equal(port[i], ref[i])
    with pytest.raises(IndexError):
        port[4]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The same two domains as a synthetic dataset, PNG folders and packed
    ``.npy`` files (packed by the JAX package)."""
    root = tmp_path_factory.mktemp("data")
    syn = jds.SyntheticUnpairedDataset(N, LOAD, SEED)
    dir_a, dir_b = syn.write_png_dirs(str(root))
    npy_a, npy_b = str(root / "a.npy"), str(root / "b.npy")
    jds.PackedDataset.pack(syn.domain_a, npy_a)
    jds.PackedDataset.pack(syn.domain_b, npy_b)
    return {"synthetic": ("", ""), "folders": (dir_a, dir_b),
            "packed": (npy_a, npy_b)}


def _cfgs(source, paths, producers):
    over = [f"data.source={source}", f"data.dir_a={paths[0]}",
            f"data.dir_b={paths[1]}", f"data.load_size={LOAD}",
            f"data.batch_size={BATCH}", f"data.synthetic_len={N}",
            f"data.shuffle_seed={SEED}", "data.num_workers=2",
            f"data.producer_threads={producers}"]
    return (apply_overrides(get_preset("smoke64"), over),
            jax_overrides(jax_preset("smoke64"), over))


def _jax_pipeline(jcfg):
    """JAX's pipeline of ``jcfg`` with ``mesh=None``; folders through the
    PIL decoder (JAX's ``make_input_pipeline`` would pick the native one
    where it is built)."""
    d = jcfg.data
    if d.source == "synthetic":
        syn = jds.SyntheticUnpairedDataset(d.synthetic_len, d.load_size,
                                           d.shuffle_seed)
        a, b = syn.domain_a, syn.domain_b
    elif d.source == "folders":
        a = jds.FolderDataset(d.dir_a, d.load_size, decoder="pil")
        b = jds.FolderDataset(d.dir_b, d.load_size, decoder="pil")
    else:
        a, b = jds.PackedDataset(d.dir_a, LOAD), jds.PackedDataset(d.dir_b, LOAD)
    return JaxPipeline(a, b, d.batch_size, mesh=None, seed=d.shuffle_seed,
                       num_workers=d.num_workers, prefetch=d.prefetch,
                       producer_threads=d.producer_threads)


def _take(pipe, k):
    return [tuple(np.asarray(x) for x in next(pipe)) for _ in range(k)]


@pytest.mark.parametrize("producers", [1, 3])
@pytest.mark.parametrize("source", ["synthetic", "folders", "packed"])
def test_pipeline_batches_are_byte_equal(sources, source, producers):
    """Seven batches (three epochs of 5 images at batch 2), then the cursor
    put back to batch 2 in the middle of the stream and three more."""
    cfg, jcfg = _cfgs(source, sources[source], producers)
    port = make_input_pipeline(cfg, device="cpu")
    ref = _jax_pipeline(jcfg).start()
    try:
        got, want = _take(port, 7), _take(ref, 7)
        assert port.state_dict() == ref.state_dict() == {"t_consumed": 7}
        port.load_state_dict({"t_consumed": 2})
        ref.load_state_dict({"t_consumed": 2})
        got += _take(port, 3)
        want += _take(ref, 3)
    finally:
        port.stop()
        ref.stop()
    for (ga, gb), (wa, wb) in zip(got, want, strict=True):
        assert ga.dtype == np.uint8 and ga.shape == (BATCH, LOAD, LOAD, 3)
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(got[7][0], got[2][0])  # the resumed cursor


def test_pipeline_unstarted_yields_cpu_tensors(sources):
    """``next`` on a pipeline never started starts its producers, and after
    ``stop`` starts them again at the cursor; on the CPU device it yields
    CPU tensors of JAX's bytes."""
    cfg, jcfg = _cfgs("synthetic", sources["synthetic"], 1)
    port = make_input_pipeline(cfg, device="cpu", start=False)
    ref = _jax_pipeline(jcfg)
    try:
        for i in range(5):
            if i == 3:
                port.stop()  # the producers had claimed batches past 3
            a, b = next(port)
            assert isinstance(a, torch.Tensor) and a.dtype == torch.uint8
            wa, wb = next(ref)
            np.testing.assert_array_equal(a.numpy(), wa)
            np.testing.assert_array_equal(b.numpy(), wb)
    finally:
        port.stop()


def test_eval_datasets_and_refused_sources(sources):
    cfg, jcfg = _cfgs("packed", sources["packed"], 1)
    for port, ref in zip(eval_datasets(cfg), jax_eval_datasets(jcfg)):
        assert isinstance(port, PackedDataset)
        np.testing.assert_array_equal(port.get_batch([4, 0]),
                                      ref.get_batch([4, 0]))
    for source in ("tfrecord", "webdataset"):
        bad, _ = _cfgs(source, ("x", "y"), 1)
        with pytest.raises(NotImplementedError, match="item 14"):
            make_input_pipeline(bad, device="cpu")
        with pytest.raises(NotImplementedError, match="item 14"):
            eval_datasets(bad)


def test_pack_equals_jax_pack(sources, tmp_path):
    """``pack`` (through the CLI) writes the bytes JAX's ``PackedDataset.pack``
    writes for the same folder; the folder's ``get_batch`` decodes what
    JAX's PIL decoder does, with one and with several threads."""
    from uig_torch.cli.__main__ import main

    dir_a = sources["folders"][0]
    ours, theirs = tmp_path / "ours.npy", tmp_path / "theirs.npy"
    assert main(["pack", "--input-dir", dir_a, "--output", str(ours),
                 "--load-size", "10"]) == 0
    ref = jds.FolderDataset(dir_a, 10, decoder="pil")
    assert jds.PackedDataset.pack(ref, str(theirs)) == N
    assert ours.read_bytes() == theirs.read_bytes()
    port = FolderDataset(dir_a, 10)
    for threads in (1, 3):
        np.testing.assert_array_equal(port.get_batch([3, 1, 3], threads),
                                      ref.get_batch([3, 1, 3], 1))
    with pytest.raises(ValueError, match="load_size=12"):
        PackedDataset(str(ours), 12)


def test_pipeline_producer_error_reaches_the_consumer():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError("unreadable image")

    ok = tds._SyntheticDomain("blobs", 4, 8, 0)
    pipe = UnpairedPipeline(ok, Broken(), 2, device="cpu",
                            num_workers=1).start()
    try:
        with pytest.raises(RuntimeError, match="producer died"):
            next(pipe)
    finally:
        pipe.stop()
