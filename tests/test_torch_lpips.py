"""The port's LPIPS (``uig_torch.eval.lpips``) against the JAX package's
``uig.eval.lpips.make_lpips``, on the CPU, fp32, at 32² (batch 2), with
JAX's seed-0 VGG carried into the port through ``uig_torch.convert``:

* ``VGG16Features`` tap by tap: each tap within 1e-5 of its largest value
  (13 fp32 convs in another order of sums; the port reads 1e-7 to 1e-6);
* the distance in both lin modes (equal channel weights with a layer
  average, and lin weights drawn with numpy, written to a file the JAX
  function reads): rtol 1e-5, the bar of ``tests/unit/test_lpips_oracle.py``;
* its gradient with respect to each input, in both modes: within 1e-4 of
  the largest gradient element (the backward of the 13 convs in another
  order; the port reads ~1e-6 to 1e-5);
* both ``.npz`` loaders on files the test writes, and the VGG's parameters
  carried to flax's flat layout and back, bit for bit;
* the CycleGAN and VQGAN generator losses with LPIPS on: the LPIPS-off loss
  plus the term, with the gradients of both parts summing to the
  gradient (1e-6 of the largest element: the same fp32 products, summed
  in another order).

JAX's side is one ``make_lpips`` per mode (its VGG drawn eagerly; the
first draw is most of the file's time on one core, the second reuses its
compiled ops) and one compile of both modes' values and input gradients,
through the functions' own traces; the VGG carried across is the one the
functions close over. No JAX trainer is built.
"""

import inspect

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.core import eval_jaxpr

from uig.eval.lpips import VGG16Features as JaxVGG
from uig.eval.lpips import make_lpips as jax_make_lpips
from uig_torch.config import apply_overrides, get_preset
from uig_torch.convert import flax_from_generator_state
from uig_torch.eval.lpips import (LPIPS, VGG16Features, load_lins, make_lpips,
                                  vgg_from_flax)
from uig_torch.train import CycleGANTrainer, VQGANTrainer
from uig_torch.train import losses as L

CHANNELS = (64, 128, 256, 512, 512)
MODES = ("equal", "lin")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's seed-0 VGG (flat, numpy), the lin weights and their file, the
    inputs, and JAX's taps, distances and input gradients."""
    d = tmp_path_factory.mktemp("lpips")
    rng = np.random.default_rng(0)
    lins = [rng.uniform(0.0, 1.0, c).astype(np.float32) for c in CHANNELS]
    lin_path = str(d / "lin.npz")
    np.savez(lin_path, **{f"lin{i}": w for i, w in enumerate(lins)})
    fns = {"equal": jax_make_lpips(None), "lin": jax_make_lpips(
        None, lin_path=lin_path)}
    # the VGG that make_lpips drew (PRNGKey(0)) and its function closes over
    params = inspect.getclosurevars(fns["equal"]).nonlocals["params"]
    x = rng.uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1.0, 1.0).astype(
        np.float32)

    # each mode's function as make_lpips returns it, traced once, its
    # closed-over VGG passed to the one compile as arguments (as constants
    # they would cost XLA three times the compile)
    jaxprs = {m: jax.make_jaxpr(f)(x, y) for m, f in fns.items()}

    def both(x, y, consts, params):
        return {m: jax.value_and_grad(
            lambda x, y: eval_jaxpr(j.jaxpr, consts[m], x, y)[0],
            argnums=(0, 1))(x, y) for m, j in jaxprs.items()}, \
            JaxVGG().apply(params, x)

    args = (x, y, {m: j.consts for m, j in jaxprs.items()}, params)
    # XLA's backend at optimization level 0: the same program, compiled in
    # a fraction of the time
    out, taps = jax.jit(both).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return {
        "flat": {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
            params, sep="/").items()},
        "lins": lins, "lin_path": lin_path, "dir": d, "x": x, "y": y,
        "taps": [np.asarray(t) for t in taps],
        "value": {m: float(v) for m, (v, _) in out.items()},
        "grad": {m: [np.asarray(g) for g in gs] for m, (_, gs) in out.items()},
    }


@pytest.fixture
def one_thread():
    """PyTorch's multi-threaded CPU conv backward sums in no fixed order;
    the loss tests compare sums of gradients taken in separate passes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port(ref):
    """The port's LPIPS in both modes on JAX's VGG, and its distances and
    input gradients at the reference inputs."""
    vgg = vgg_from_flax(ref["flat"])
    out = {"equal": LPIPS(vgg), "lin": LPIPS(vgg, ref["lins"])}
    for m in MODES:
        x, y = _t(ref["x"], True), _t(ref["y"], True)
        d = out[m](x, y)
        out[f"{m}_value"] = float(d.detach())
        out[f"{m}_grad"] = [g.numpy() for g in torch.autograd.grad(d, (x, y))]
    return out


def _t(a: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(a.copy()).requires_grad_(grad)


@pytest.mark.parametrize("tap", range(5))
def test_vgg_taps(ref, port, tap):
    with torch.no_grad():
        got = port["equal"].vgg(_t(ref["x"]))[tap].numpy()
    want = ref["taps"][tap]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
def test_lpips_value(ref, port, mode):
    np.testing.assert_allclose(port[f"{mode}_value"], ref["value"][mode],
                               rtol=1e-5)
    assert ref["value"][mode] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wrt", (0, 1), ids=("x", "y"))
def test_lpips_grad(ref, port, mode, wrt):
    got = port[f"{mode}_grad"][wrt]
    want = ref["grad"][mode][wrt]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_loaders_and_convert(ref, port):
    """The VGG and lin files the test writes load into the port bit for bit
    (the lin file also through ``eval.lpips_lin_weights``), the VGG carries
    back to flax's keys unchanged, and a missing key is refused."""
    vgg_path = str(ref["dir"] / "vgg.npz")
    np.savez(vgg_path, **ref["flat"])
    loaded = make_lpips(None, vgg_path, ref["lin_path"], device="cpu")
    back = flax_from_generator_state(loaded.vgg.state_dict())
    assert set(back) == set(ref["flat"])
    for k, v in ref["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for got, want in zip(load_lins(ref["lin_path"]), ref["lins"]):
        np.testing.assert_array_equal(got, want)
    cfg = apply_overrides(get_preset("cyclegan256_dp"),
                          [f"eval.lpips_lin_weights={ref['lin_path']}"])
    via_cfg = make_lpips(cfg, vgg_path, device="cpu")
    with torch.no_grad():
        x, y = _t(ref["x"]), _t(ref["y"])
        want = port["lin"](x, y)
        assert torch.equal(loaded(x, y), want)
        assert torch.equal(via_cfg(x, y), want)
    bad = dict(ref["flat"])
    del bad["params/conv12/bias"]
    with pytest.raises(KeyError, match="conv12.bias"):
        vgg_from_flax(bad)


def test_seeded_vgg_is_flax_init_shaped():
    """Without a weight file the port draws its own VGG: flax's shapes,
    lecun-normal kernels (std sqrt(1 / fan_in) within the truncation),
    zero biases, the same draw for the same seed."""
    a = make_lpips(device="cpu").vgg.state_dict()
    b = make_lpips(device="cpu").vgg.state_dict()
    want = VGG16Features().state_dict()
    assert set(a) == set(want)
    for k, t in a.items():
        assert t.shape == want[k].shape and torch.equal(t, b[k])
        if k.endswith("bias"):
            assert not t.any()
        else:
            fan_in = float(np.prod(t.shape[:-1]))
            assert abs(float(t.std()) * fan_in ** 0.5 - 1.0) < 0.1


def _grads_close(got, want, what):
    """Every leaf within 1e-5 of the network's largest gradient element,
    the step tests' bar (the gradients of a deep net summed in another
    order; 2e-6 to 3e-6 read here)."""
    scale = max(float(t.abs().max()) for t in want.values())
    worst = max(float((got[k] - want[k]).abs().max()) for k in want) / scale
    print(f"{what}: largest gradient gap {worst:.3g} of the largest element")
    assert worst <= 1e-5


_CYC = ["model.image_size=32", "data.load_size=36", "data.batch_size=2",
        "model.g_base_features=8", "model.n_res_blocks=1",
        "model.d_base_features=8", "model.compute_dtype=float32"]


def test_cyclegan_g_loss_adds_the_term(port, one_thread):
    """``_g_loss`` with LPIPS on (lambda 1.5) = the LPIPS-off loss +
    1.5 (lpips(real_a, rec_a) + lpips(real_b, rec_b)), and its gradient is
    the sum of both parts' gradients."""
    lp = port["equal"]
    on = CycleGANTrainer(apply_overrides(get_preset("cyclegan256_dp"),
                                         _CYC + ["loss.lambda_lpips=1.5"]),
                         device="cpu", perceptual_fn=lp)
    off = CycleGANTrainer(apply_overrides(get_preset("cyclegan256_dp"),
                                          _CYC + ["loss.lambda_lpips=0"]),
                          device="cpu")
    assert off.perceptual_fn is None
    state = on.init_state(0)
    rng = np.random.default_rng(1)
    real_a, real_b = (torch.from_numpy(rng.uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)) for _ in range(2))

    def loss_and_grads(tr, extra):
        gp = tr._with_grad(state.g_params)
        total, aux = tr._g_loss(gp, state.d_params, real_a, real_b)
        if extra:
            rec_a = tr._G(gp["b2a"], tr._G(gp["a2b"], real_a))
            rec_b = tr._G(gp["a2b"], tr._G(gp["b2a"], real_b))
            total = 1.5 * (lp(real_a, rec_a) + lp(real_b, rec_b))
        names = [f"{n}/{k}" for n in gp for k in gp[n]]
        leaves = [gp[n][k] for n in gp for k in gp[n]]
        return total, aux, dict(zip(names, torch.autograd.grad(total, leaves)))

    t_on, aux_on, g_on = loss_and_grads(on, False)
    t_off, _, g_off = loss_and_grads(off, False)
    term, _, g_term = loss_and_grads(on, True)
    assert float(term.detach()) > 0
    torch.testing.assert_close(aux_on["g_lpips"], term, rtol=1e-6, atol=0)
    torch.testing.assert_close(t_on, t_off + term, rtol=1e-6, atol=0)
    _grads_close(g_on, {k: g_off[k] + g_term[k] for k in g_on}, "cyclegan")


_VQ = ["model.image_size=32", "data.load_size=36", "data.batch_size=2",
       "model.vq_base_features=16", "model.vq_channel_mults=(1,2)",
       "model.vq_embed_dim=8", "model.vq_codebook_size=32",
       "model.vq_attn_resolutions=(16,)", "model.d_layers=2",
       "model.compute_dtype=float32", "loss.vq_disc_start=0"]


def test_vqgan_g_loss_adds_the_term(port, one_thread):
    """With D gated off the VQGAN G loss with LPIPS on (lambda 0.7) is the
    LPIPS-off loss + 0.7 lpips(x, recon), with gradients to match; with D
    on, the adaptive weight's NLL holds the term: lambda_adapt =
    |grad_W (rec + term)| / (|grad_W adv| + 1e-4) at the decoder's last
    kernel W."""
    lp = port["equal"]

    def trainer(extra):
        return VQGANTrainer(apply_overrides(get_preset("vqgan512"),
                                            _VQ + extra),
                            device="cpu", perceptual_fn=lp)

    gated = ["loss.vq_disc_start=5"]
    on, off = trainer(gated + ["loss.lambda_lpips=0.7"]), trainer(
        gated + ["loss.lambda_lpips=0"])
    state = on.init_state(0)
    rng = np.random.default_rng(2)
    batch = tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                  for _ in range(2))
    draws = on.draw(state, 2, 36, 36)
    g_on, m_on = on._grads(state, batch, draws)
    g_off, m_off = off._grads(state, batch, draws)
    gp = {k: t.detach().requires_grad_(True) for k, t in
          state.g_params.items()}
    x = torch.cat([on._input(batch[0], draws["aug_a"]),
                   on._input(batch[1], draws["aug_b"])], 0)
    term = 0.7 * lp(x, on._G(gp, x)[0])
    g_term = dict(zip(gp, torch.autograd.grad(term, list(gp.values()),
                                              allow_unused=True)))
    torch.testing.assert_close(m_on["lpips"], term.detach(), rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(m_on["g_loss"], m_off["g_loss"] + term.detach(),
                               rtol=1e-6, atol=0)
    _grads_close(g_on["g"], {k: g_off["g"][k] + (
        0 if g_term[k] is None else g_term[k]) for k in g_on["g"]}, "vqgan")

    live = trainer(["loss.lambda_lpips=0.7"])
    _, m = live._grads(state, batch, draws)
    recon = live._G(gp, x)[0]
    w = gp[live.last_kernel]
    nll = L.l1_loss(x, recon) + 0.7 * lp(x, recon)
    g_nll, = torch.autograd.grad(nll, w, retain_graph=True)
    g_adv, = torch.autograd.grad(L.gan_loss_g(live._D(state.d_params, recon),
                                              live.cfg.loss.gan_mode), w)
    want = torch.linalg.vector_norm(g_nll) / (
        torch.linalg.vector_norm(g_adv) + 1e-4)
    torch.testing.assert_close(m["lambda_adapt"], want, rtol=1e-5, atol=0)
