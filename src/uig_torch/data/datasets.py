"""Index-addressable image datasets for training: the port of the JAX
package's ``data/datasets.py``.

Every dataset maps an index to a uint8 (load, load, 3) HWC image; the
pipeline (``data/pipeline.py``) gathers them into batches. Three sources:

* ``FolderDataset`` (``data/folder.py``): a directory of image files, PIL
  decode and bilinear resize, as JAX's ``decoder="pil"``;
* ``PackedDataset``: pre-decoded images in one memmapped ``.npy`` (N, S, S,
  3), written by ``PackedDataset.pack`` (``python -m uig_torch.cli pack``);
* ``SyntheticUnpairedDataset``: two procedural domains (blobs, stripes)
  drawn from ``default_rng((seed, crc32(kind) & 0xFFFF, idx))`` with JAX's
  float32 arithmetic, so the port and JAX give the same bytes.

``tfrecord`` and ``webdataset`` are not ported (``open_dataset`` and
``resolve_dataset`` raise). ``resolve_dataset`` detects a path's source as
the JAX package does, for the translate and eval commands.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from uig_torch.data.folder import FolderDataset

def refuse_unported_source(source: str) -> None:
    if source in ("tfrecord", "webdataset"):
        raise NotImplementedError(
            f"data.source={source!r} is not ported yet (ROADMAP §1 item 14, "
            "the tfrecord and webdataset readers); use folders, packed or "
            "synthetic, or pack the data with `python -m uig_torch.cli pack`")


def open_dataset(source: str, path: str, load_size: int):
    """The dataset of one domain for ``data.source`` folders | packed."""
    refuse_unported_source(source)
    if source == "folders":
        return FolderDataset(path, load_size)
    if source == "packed":
        return PackedDataset(path, load_size)
    raise ValueError(f"unknown data source {source!r}")


def resolve_dataset(path: str, load_size: int, source: str = "auto"):
    """Open an index-addressable dataset of any supported on-disk format.

    ``source``: folders | packed | tfrecord | webdataset | auto. "auto"
    detects by path shape, as the JAX package's ``resolve_dataset``: a
    ``.npy`` file -> packed; a ``.tfrecord(s)`` file or a directory holding
    one -> tfrecord; a ``.tar`` file or a directory holding one ->
    webdataset; any other directory -> image folder. tfrecord and
    webdataset are not ported yet (ROADMAP §1 item 14) and raise.
    """
    if source == "auto":
        if path.endswith(".npy"):
            source = "packed"
        elif path.endswith((".tfrecord", ".tfrecords")):
            source = "tfrecord"
        elif path.endswith(".tar"):
            source = "webdataset"
        elif os.path.isdir(path):
            entries = os.listdir(path)
            if any(f.endswith((".tfrecord", ".tfrecords")) for f in entries):
                source = "tfrecord"
            elif any(f.endswith(".tar") for f in entries):
                source = "webdataset"
            elif any(f.endswith(".npy") for f in entries):
                raise ValueError(
                    f"{path!r} is a directory of packed .npy shards — point "
                    "at one .npy file (source=packed), not the directory")
            else:
                source = "folders"
        elif os.path.exists(path):
            raise ValueError(
                f"dataset path {path!r} exists but has an unrecognized "
                "format (expected an image directory, a packed .npy file, "
                "or a .tfrecord file)")
        else:
            raise FileNotFoundError(
                f"dataset path {path!r} does not exist (expected an image "
                "directory, a packed .npy file, or a .tfrecord file)")
    if source in ("folders", "packed", "tfrecord", "webdataset"):
        return open_dataset(source, path, load_size)
    raise ValueError(f"unknown dataset source {source!r}")


class PackedDataset:
    """Pre-decoded images in one memmapped ``.npy`` (N, S, S, 3) uint8 file.
    Random access is a page read of the map: no decode on the hot path."""

    def __init__(self, path: str, load_size: int | None = None):
        self.path = path
        self.arr = np.load(path, mmap_mode="r")
        if self.arr.ndim != 4 or self.arr.shape[-1] != 3 or \
                self.arr.dtype != np.uint8:
            raise ValueError(
                f"{path}: expected uint8 (N, S, S, 3), got "
                f"{self.arr.dtype} {self.arr.shape}")
        if load_size is not None and self.arr.shape[1] != load_size:
            raise ValueError(
                f"{path} is packed at {self.arr.shape[1]}px, config wants "
                f"load_size={load_size}; re-pack or fix the config")

    def __len__(self) -> int:
        return self.arr.shape[0]

    def __getitem__(self, idx: int) -> np.ndarray:
        return np.asarray(self.arr[idx])

    def get_batch(self, idxs: list[int], n_threads: int = 0) -> np.ndarray:
        del n_threads  # a gather from the map needs no workers
        return np.asarray(self.arr[np.asarray(idxs)])

    @staticmethod
    def pack(src, out_path: str) -> int:
        """Pack any index-addressable dataset into a ``.npy``; returns the
        count."""
        n = len(src)
        first = src[0]
        arr = np.lib.format.open_memmap(
            out_path, mode="w+", dtype=np.uint8, shape=(n,) + first.shape)
        arr[0] = first
        for i in range(1, n):
            arr[i] = src[i]
        arr.flush()
        return n


class _SyntheticDomain:
    """One procedural domain; index i -> a deterministic uint8 image."""

    def __init__(self, kind: str, n: int, size: int, seed: int):
        self.kind = kind
        self.n = n
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> np.ndarray:
        # the IndexError ends ``for img in domain`` (the sequence protocol)
        if not 0 <= idx < self.n:
            raise IndexError(
                f"synthetic domain index {idx} out of range [0, {self.n})")
        # crc32, not hash(): string hashing differs from process to process
        kind_tag = zlib.crc32(self.kind.encode()) & 0xFFFF
        rng = np.random.default_rng((self.seed, kind_tag, idx))
        s = self.size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        if self.kind == "blobs":
            img = np.stack([0.2 + 0.6 * yy, 0.3 * np.ones_like(yy),
                            0.2 + 0.6 * xx], -1)
            for _ in range(rng.integers(2, 6)):
                cy, cx = rng.uniform(0.15, 0.85, 2)
                r = rng.uniform(0.05, 0.25)
                col = rng.uniform(0.2, 1.0, 3)
                mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < r**2
                img[mask] = col
        elif self.kind == "stripes":
            freq = rng.uniform(4, 16)
            phase = rng.uniform(0, 2 * np.pi)
            angle = rng.uniform(0, np.pi)
            t = np.cos(angle) * xx + np.sin(angle) * yy
            wave = 0.5 + 0.5 * np.sin(2 * np.pi * freq * t + phase)
            base = rng.uniform(0.1, 0.9, 3)
            img = wave[..., None] * base + (1 - wave[..., None]) * (1 - base)
        elif self.kind == "checker":
            cells = rng.integers(3, 9)
            oy, ox = rng.uniform(0, 1, 2)
            board = ((np.floor((yy + oy) * cells) + np.floor((xx + ox) * cells))
                     % 2).astype(np.float32)
            c0 = rng.uniform(0.05, 0.45, 3)
            c1 = rng.uniform(0.55, 0.95, 3)
            img = board[..., None] * c1 + (1 - board[..., None]) * c0
        elif self.kind == "rings":
            cy, cx = rng.uniform(0.25, 0.75, 2)
            freq = rng.uniform(4, 12)
            phase = rng.uniform(0, 2 * np.pi)
            rr = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            wave = 0.5 + 0.5 * np.cos(2 * np.pi * freq * rr + phase)
            base = rng.uniform(0.1, 0.9, 3)
            img = wave[..., None] * base + (1 - wave[..., None]) * (1 - base)
        else:
            raise ValueError(self.kind)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)


class SyntheticUnpairedDataset:
    """Two unpaired procedural domains (A: blobs, B: stripes)."""

    def __init__(self, n: int = 200, load_size: int = 72, seed: int = 0):
        self.domain_a = _SyntheticDomain("blobs", n, load_size, seed)
        self.domain_b = _SyntheticDomain("stripes", n, load_size, seed + 1)


def eval_datasets(cfg):
    """(domain_a, domain_b) index-addressable datasets of ``cfg.data``: the
    training pipeline's domains (``make_input_pipeline``) and the sample
    grid's."""
    d = cfg.data
    if d.source == "synthetic":
        syn = SyntheticUnpairedDataset(d.synthetic_len, d.load_size,
                                       d.shuffle_seed)
        return syn.domain_a, syn.domain_b
    return (open_dataset(d.source, d.dir_a, d.load_size),
            open_dataset(d.source, d.dir_b, d.load_size))

