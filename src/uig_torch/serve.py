"""HTTP micro-batching server over the port's ``Translator``.

The port's copy of the JAX package's ``uig.serve``: a stdlib
``http.server`` front end whose single dispatcher thread collects up to the
static batch B of concurrent requests, waiting at most ``max_delay_ms``
after the first, and runs them as one ``Translator`` call (which pads the
tail and trims). Requests are decoded as the translate CLI decodes files:
PIL RGB decode, bilinear resize to the load size.

Endpoints:
  POST /translate   image bytes (anything PIL decodes) -> PNG bytes
  GET  /healthz     {"ok": true, "kind": ..., "batch": B}
  GET  /stats       requests, batches, mean occupancy, p50/p95 latency, img/s

Run: ``python -m uig_torch.cli serve --preset cyclegan256_dp --weights g.npz
[--port 8000] [--max-delay-ms 5]``.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Pending:
    """One enqueued request: the preprocessed image and a completion event."""

    __slots__ = ("img", "event", "out", "err", "t_in")

    def __init__(self, img: np.ndarray):
        self.img = img
        self.event = threading.Event()
        self.out = None
        self.err = None
        self.t_in = time.perf_counter()


class BatchingTranslator:
    """Micro-batching front end over a ``Translator``.

    ``submit(img_u8[L,L,3]) -> img_u8[crop,crop,3]`` blocks the calling
    thread until its batch retires. A single dispatcher thread owns the
    translator call: it drains the queue up to the static batch B, waiting at
    most ``max_delay_ms`` after the first item so a lone request is never
    stalled behind a full-batch timeout."""

    def __init__(self, translator, max_delay_ms: float = 5.0,
                 stats_window: int = 1024):
        self._translator = translator
        self.batch = translator.batch
        self.max_delay = max_delay_ms / 1000.0
        self._q: queue.Queue[_Pending] = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._latencies: deque[float] = deque(maxlen=stats_window)
        self._n_requests = 0
        self._n_images = 0
        self._n_batches = 0
        self._occupancy = 0
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="uig-torch-serve-dispatcher")
        self._thread.start()

    # -- client side -----------------------------------------------------
    def submit(self, img: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        expect = tuple(self._translator.meta["input"][1:])
        if img.shape != expect or img.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 image of shape {expect}, got "
                f"{img.dtype} {img.shape}")
        p = _Pending(img)
        self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("translate batch did not retire in time")
        if p.err is not None:
            raise p.err
        return p.out

    # -- dispatcher ------------------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:  # shutdown sentinel
                return
            items = [first]
            deadline = time.perf_counter() + self.max_delay
            while len(items) < self.batch:
                rem = deadline - time.perf_counter()
                if rem <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=rem)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(items)
                    return
                items.append(nxt)
            self._flush(items)

    def _flush(self, items):
        try:
            raw = np.stack([p.img for p in items])
            out = self._translator(raw)  # pads+trims internally
            now = time.perf_counter()
            with self._lock:
                self._n_batches += 1
                self._occupancy += len(items)
                self._n_requests += len(items)
                self._n_images += len(items)
                for p in items:
                    self._latencies.append(now - p.t_in)
            for i, p in enumerate(items):
                p.out = out[i]
                p.event.set()
        except Exception as e:  # surface the failure to every waiter
            for p in items:
                p.err = e
                p.event.set()

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            elapsed = time.perf_counter() - self._t0
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "static_batch": self.batch,
                "mean_occupancy": (self._occupancy / self._n_batches
                                   if self._n_batches else 0.0),
                "latency_p50_ms": (1e3 * lat[len(lat) // 2] if lat else None),
                "latency_p95_ms": (1e3 * lat[int(len(lat) * 0.95)]
                                   if lat else None),
                "images_per_sec": self._n_images / elapsed if elapsed else 0.0,
                "uptime_sec": elapsed,
            }

    def close(self):
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=5)


def _make_handler(batcher: BatchingTranslator, meta: dict, load_size: int):
    from PIL import Image

    from uig_torch.data.folder import decode_resize

    class Handler(BaseHTTPRequestHandler):
        # quiet: production logs go through /stats, not stderr per-request
        def log_message(self, fmt, *args):
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "kind": meta.get("kind"),
                                 "batch": batcher.batch})
            elif self.path == "/stats":
                self._json(200, batcher.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/translate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                out = batcher.submit(decode_resize(io.BytesIO(raw), load_size))
                buf = io.BytesIO()
                Image.fromarray(out).save(buf, format="PNG")
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class ServeHandle:
    """A running server (tests / embedding): .port, .url, .close()."""

    def __init__(self, httpd: ThreadingHTTPServer,
                 batcher: BatchingTranslator):
        self._httpd = httpd
        self._batcher = batcher
        self.port = httpd.server_address[1]
        self.url = f"http://{httpd.server_address[0]}:{self.port}"
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        daemon=True, name="uig-torch-serve-http")
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._batcher.close()


def start_server(config: str, weights: str, direction: str = "a2b",
                 batch_size: int = 8, device: str = "cuda",
                 host: str = "127.0.0.1", port: int = 0,
                 max_delay_ms: float = 5.0, overrides=()) -> ServeHandle:
    """Build a ``Translator`` and serve it. ``port=0`` picks a free one
    (reported on the returned handle). Returns immediately; the server runs
    on daemon threads until ``handle.close()``."""
    from uig_torch.serving import Translator

    translator = Translator(config, weights, direction=direction,
                            batch_size=batch_size, device=device,
                            overrides=overrides)
    # one warmup call so the first real request does not pay for the build
    load = translator.meta["input"][1]
    translator(np.zeros((1, load, load, 3), np.uint8))
    batcher = BatchingTranslator(translator, max_delay_ms=max_delay_ms)
    handler = _make_handler(batcher, translator.meta, load)
    httpd = ThreadingHTTPServer((host, port), handler)
    return ServeHandle(httpd, batcher)


def run_serve(config: str, weights: str, direction: str = "a2b",
              batch_size: int = 8, device: str = "cuda",
              host: str = "127.0.0.1", port: int = 8000,
              max_delay_ms: float = 5.0, overrides=()) -> int:
    """CLI entry: serve until SIGINT/SIGTERM."""
    import signal

    handle = start_server(config, weights, direction, batch_size, device, host,
                          port, max_delay_ms, overrides)
    print(json.dumps({"serving": config, "weights": weights, "host": host,
                      "port": handle.port, "max_delay_ms": max_delay_ms}),
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        handle.close()
    return 0
