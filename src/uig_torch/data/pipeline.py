"""The unpaired two-domain input pipeline: the port of the JAX package's
``data/pipeline.py``.

Host side, as in JAX: the batch stream is a pure function of (seed, batch
counter). Batch ``t`` reads stream positions ``t*B .. t*B + B - 1`` of each
domain through per-epoch permutations drawn from ``default_rng((seed,
epoch))`` (domain B's seed is ``seed + 0x9E3779B9``), so the iterator's
checkpoint is one integer, the count of batches consumed, and prefetching
cannot desynchronize a resume. Producer threads claim batch counters under a
lock, at most ``prefetch + producer_threads`` ahead of the consumer; the
consumer puts batches back in order through a reorder buffer.

Device side, the port's own (JAX ``device_put``s): with a CUDA ``device``
the producer copies each uint8 batch into pinned host memory, starts a
``non_blocking`` copy to the card on the pipeline's own copy stream and
records an event after it. The consumer's stream waits on that event before
anything reads the batch, the device tensors are marked as used by the
consumer's stream (``record_stream``) so the allocator does not hand their
memory to a later copy before the step that reads them has run, and the
pipeline keeps the delivered batch, pinned buffers included, until the next
one is taken. The producer launches no kernel. Batches stay uint8 (B, load,
load, 3): crop, flip and scale happen in the step (``augment_batch``).

With ``device="cpu"`` the batches are CPU tensors that share the numpy
arrays' memory.
"""

from __future__ import annotations

import queue
import threading
import time as _time

import numpy as np
import torch

from uig_torch.data.datasets import eval_datasets
from uig_torch.runtime import resolve_device

SEED_B = 0x9E3779B9  # domain B's stream seed offset, as in JAX


class _DomainStream:
    """Pure-function index stream: position -> dataset index."""

    def __init__(self, n: int, seed: int):
        if n == 0:
            raise ValueError("every domain needs at least one image")
        self.n = n
        self.seed = seed
        self._perm_cache: dict[int, np.ndarray] = {}

    def _perm(self, epoch: int) -> np.ndarray:
        # safe under concurrent producers without a lock: read a local
        # snapshot, publish by swapping in a new dict (adjacent epochs kept)
        cache = self._perm_cache
        perm = cache.get(epoch)
        if perm is None:
            perm = np.random.default_rng((self.seed, epoch)).permutation(self.n)
            new = {k: v for k, v in cache.items() if abs(k - epoch) <= 1}
            new[epoch] = perm
            self._perm_cache = new
        return perm

    def indices_at(self, start: int, k: int) -> list[int]:
        out = []
        for g in range(start, start + k):
            epoch, pos = divmod(g, self.n)
            out.append(int(self._perm(epoch)[pos]))
        return out


class _DeviceBatch:
    """A batch on the card: its tensors, the pinned buffers they were
    copied from, and the event recorded after the copies."""

    __slots__ = ("tensors", "pinned", "event")

    def __init__(self, tensors, pinned, event):
        self.tensors, self.pinned, self.event = tensors, pinned, event


class UnpairedPipeline:
    """Infinite iterator of (batch_a, batch_b) uint8 (B, load, load, 3)."""

    def __init__(self, dataset_a, dataset_b, batch_size_local: int,
                 device="cuda", seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, producer_threads: int = 1):
        self.datasets = [dataset_a, dataset_b]
        self.streams = [_DomainStream(len(dataset_a), seed),
                        _DomainStream(len(dataset_b), seed + SEED_B)]
        self.batch = batch_size_local
        self.device = resolve_device(device)
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.producer_threads = max(1, producer_threads)
        self._t_next = 0       # next batch counter a producer will claim
        self._t_lock = threading.Lock()
        self._t_consumed = 0   # batches handed to the trainer
        self._q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._reorder: dict[int, object] = {}
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._error: Exception | None = None
        self._pool = None      # decode workers, made by _ensure_pool
        self._in_use = None    # the last delivered device batch
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    # ---------------- host production ----------------
    def _ensure_pool(self) -> None:
        """The decode pool; made by the consumer thread before any producer
        starts, so producers never race to make it."""
        if self._pool is None and self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(self.num_workers)

    def _load_domain(self, ds, stream: _DomainStream, start: int,
                     k: int) -> np.ndarray:
        """Decode k images of one domain from stream position ``start``."""
        idx = stream.indices_at(start, k)
        if hasattr(ds, "get_batch"):
            return ds.get_batch(idx, self.num_workers)
        if self._pool is not None and k > 1:
            return np.stack(list(self._pool.map(ds.__getitem__, idx)))
        return np.stack([ds[i] for i in idx])

    def _load_batch(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        return tuple(self._load_domain(ds, st, t * self.batch, self.batch)
                     for ds, st in zip(self.datasets, self.streams))

    def _put_device(self, batch):
        if self.device.type == "cpu":
            return tuple(torch.from_numpy(np.ascontiguousarray(x))
                         for x in batch)
        pinned = []
        for x in batch:
            p = torch.empty(x.shape, dtype=torch.uint8, pin_memory=True)
            p.numpy()[...] = x
            pinned.append(p)
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            tensors = tuple(p.to(self.device, non_blocking=True)
                            for p in pinned)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return _DeviceBatch(tensors, pinned, event)

    def _deliver(self, item):
        """What the trainer gets: for a device batch, its tensors, once the
        consumer's stream waits on the copies."""
        if not isinstance(item, _DeviceBatch):
            return item
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(item.event)
        for t in item.tensors:
            t.record_stream(consumer)
        prev, self._in_use = self._in_use, item
        if prev is not None:
            prev.event.synchronize()  # its copies are long done: frees pinned
        return item.tensors

    def _producer(self) -> None:
        try:
            while not self._stop.is_set():
                with self._t_lock:  # claim the next batch counter
                    t = self._t_next
                    # at most prefetch + producers ahead of the consumer; a
                    # stale _t_consumed only delays a claim
                    claim = (t < self._t_consumed + self.prefetch
                             + self.producer_threads)
                    if claim:
                        self._t_next = t + 1
                if not claim:
                    _time.sleep(0.002)
                    continue
                item = self._put_device(self._load_batch(t))
                while not self._stop.is_set():
                    try:
                        self._q.put((t, item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surface decode/copy errors to the consumer
            self._error = e
            try:
                self._q.put((-1, None), timeout=1.0)  # wake a blocked get()
            except queue.Full:
                pass

    def start(self) -> "UnpairedPipeline":
        if not self._threads:
            self._stop.clear()
            # claims restart at the cursor: what stop() dropped is made again
            self._t_next = self._t_consumed
            self._ensure_pool()
            self._threads = [threading.Thread(target=self._producer,
                                              daemon=True)
                             for _ in range(self.producer_threads)]
            for th in self._threads:
                th.start()
        return self

    def stop(self) -> None:
        """Stop the producers (draining the queue so none stays blocked on
        it) and the decode pool; ``start`` or ``next`` starts again."""
        self._stop.set()
        if self._threads:
            deadline = 10.0
            for th in self._threads:
                t0 = _time.monotonic()
                while th.is_alive():
                    try:
                        while True:
                            self._q.get_nowait()
                    except queue.Empty:
                        pass
                    th.join(timeout=0.1)
                    if _time.monotonic() - t0 > deadline:
                        break
            self._threads = []
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._reorder.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __iter__(self):
        return self

    def __next__(self):
        self.start()
        while True:
            if self._error is not None:
                raise RuntimeError("input pipeline producer died") from self._error
            if self._t_consumed in self._reorder:
                item = self._reorder.pop(self._t_consumed)
                self._t_consumed += 1
                return self._deliver(item)
            t, item = self._q.get()
            if self._error is not None or item is None:
                raise RuntimeError("input pipeline producer died") from self._error
            if t >= self._t_consumed:  # stash; stale prefetches are dropped
                self._reorder[t] = item

    # ---------------- checkpointing ----------------
    def state_dict(self) -> dict:
        return {"t_consumed": self._t_consumed}

    def load_state_dict(self, s: dict) -> None:
        running = bool(self._threads)
        if running:
            self.stop()
        self._t_consumed = int(s["t_consumed"])
        self._reorder.clear()
        if running:
            self.start()


def make_input_pipeline(cfg, device="cuda", start: bool = True
                        ) -> UnpairedPipeline:
    """The two-domain pipeline of ``cfg.data`` on one host: ``synthetic``,
    ``folders`` (``data.dir_a``/``dir_b``) or ``packed`` (one ``.npy``
    each). ``device`` as ``UnpairedPipeline`` takes it."""
    d = cfg.data
    if getattr(cfg.model, "kind", "") in ("stargan", "starganv2"):
        raise NotImplementedError(
            "the N-domain pipeline is not ported yet; it comes with StarGAN "
            "(ROADMAP §1 item 10)")
    ds_a, ds_b = eval_datasets(cfg)
    pipe = UnpairedPipeline(ds_a, ds_b, d.batch_size, device=device,
                            seed=d.shuffle_seed, num_workers=d.num_workers,
                            prefetch=d.prefetch,
                            producer_threads=d.producer_threads)
    return pipe.start() if start else pipe
