"""uig_torch.serving.Translator, the port's HTTP server and CLI, on the CPU,
against the JAX serving path (center_crop_normalize -> generator apply at
"highest" precision -> denormalize_to_u8) on the same weights, config.json
and uint8 inputs: within 1 uint8 step (fp32 sums in another order can move
a value across a rounding boundary)."""

import http.client
import io
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from uig.config import apply_overrides, config_to_dict, get_preset
from uig.kernels import center_crop_normalize, denormalize_to_u8
from uig.models import ResNetGenerator as JaxGenerator
from uig_torch.serve import start_server
from uig_torch.serving import Translator

OVERRIDES = ["model.image_size=16", "data.load_size=20",
             "model.g_base_features=8", "model.n_res_blocks=1"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A config.json written by the JAX package, flax weights as .npz, and a
    seeded uint8 batch."""
    d = tmp_path_factory.mktemp("run")
    cfg = apply_overrides(get_preset("smoke64"), OVERRIDES)
    (d / "config.json").write_text(json.dumps(config_to_dict(cfg)))
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (5, 20, 20, 3), dtype=np.uint8)
    gen = JaxGenerator(base_features=8, n_res_blocks=1)
    params = gen.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))
    flat = {k: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    np.savez(d / "g.npz", **flat)
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(denormalize_to_u8(gen.apply(
            params, center_crop_normalize(jnp.asarray(raw), 16))))
    return str(d), raw, ref


def _translator(run_dir, batch=4):
    return Translator(os.path.join(run_dir, "config.json"),
                      os.path.join(run_dir, "g.npz"),
                      batch_size=batch, device="cpu")


def test_translator_matches_jax_serving_path(run):
    run_dir, raw, ref = run
    tr = _translator(run_dir, batch=5)
    out = tr(raw)
    assert out.dtype == np.uint8 and out.shape == (5, 16, 16, 3)
    assert np.abs(out.astype(np.int16) - ref).max() <= 1
    assert tr.meta["input"] == [5, 20, 20, 3]
    assert tr.meta["output"] == [5, 16, 16, 3]
    assert tr.batch == 5 and tr.meta["kind"] == "cyclegan"


def test_tail_batch_is_padded_then_trimmed(run):
    run_dir, raw, _ = run
    tr = _translator(run_dir, batch=4)
    full = tr(raw[:4])
    tail = tr(raw[:3])
    assert tail.shape == (3, 16, 16, 3)
    np.testing.assert_array_equal(tail, full[:3])
    np.testing.assert_array_equal(tr(raw[:4]), full)  # deterministic
    for bad in (raw[:0], raw):
        with pytest.raises(ValueError, match="out of range"):
            tr(bad)
    with pytest.raises(ValueError, match="expected uint8"):
        tr(raw[:2].astype(np.float32))


def test_translator_needs_cuda_unless_cpu(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run_dir, _, _ = run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Translator(os.path.join(run_dir, "config.json"),
                   os.path.join(run_dir, "g.npz"))


def _post(port, img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/translate", body=buf.getvalue(),
                 headers={"Content-Type": "image/png"})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def test_http_server_answers_three_requests(run):
    run_dir, raw, _ = run
    tr = _translator(run_dir, batch=4)
    handle = start_server(os.path.join(run_dir, "config.json"),
                          os.path.join(run_dir, "g.npz"),
                          batch_size=4, device="cpu", port=0,
                          max_delay_ms=50.0)
    try:
        code, health = _get(handle.port, "/healthz")
        assert code == 200 and health == {"ok": True, "kind": "cyclegan",
                                          "batch": 4}
        results = [None] * 3
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, _post(handle.port, raw[i])))
            for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i, (status, body) in enumerate(results):
            assert status == 200, body
            got = np.asarray(Image.open(io.BytesIO(body)))
            np.testing.assert_array_equal(got, tr(raw[i:i + 1])[0])
        code, stats = _get(handle.port, "/stats")
        assert code == 200 and stats["requests"] == 3
        assert 1 <= stats["batches"] <= 3 and stats["static_batch"] == 4
        status, body = _post(handle.port, np.zeros((4, 4), np.uint8)[:, :, None]
                             .repeat(3, 2))
        assert status == 200  # resized to the load size like any request
        code, _ = _get(handle.port, "/nope")
        assert code == 404
    finally:
        handle.close()


def test_cli_translate_is_deterministic(run, tmp_path):
    from uig_torch.cli.__main__ import main

    run_dir, raw, _ = run
    src = tmp_path / "in"
    src.mkdir()
    for i in range(3):
        Image.fromarray(raw[i]).save(src / f"img{i}.png")
    outs = []
    for sub in ("o1", "o2"):
        assert main(["translate", "--preset",
                     os.path.join(run_dir, "config.json"), "--weights",
                     os.path.join(run_dir, "g.npz"), "--input-dir", str(src),
                     "--output-dir", str(tmp_path / sub), "--batch-size", "2",
                     "--device", "cpu"]) == 0
        outs.append(np.stack([np.asarray(Image.open(tmp_path / sub / f"img{i}.png"))
                              for i in range(3)]))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], _translator(run_dir, 3)(raw[:3]))
