"""The port's VQGAN generator (``uig_torch.models.vqgan``) against the JAX
package's, with the same weights (flax layout, converted by rename) and the
same numpy inputs. The port runs on the CPU (plain versions); JAX runs its
Pallas attention in interpret mode.

The small configuration is that of ``tests/integration/test_vqgan.py``:
32² images, base 16, channel mults (1, 2), embedding 8, codebook 32,
attention at 16² (N = 256 tokens, D = 32), fp32. One JAX apply with
``capture_intermediates`` gives the output of every module, which is held
against the same module of the port. The weights are
``convert.seeded_flax`` (flax's initializers), with every bias and
GroupNorm scale moved by 0.1 N(0, 1) so that they are exercised; the input
seed gives latents with no near-tie between the two nearest codewords.

Tolerances, fp32 on both sides with sums in another order: every module
output within 1e-5 of its largest value; codes equal; losses and
perplexity within 1e-5 relative; gradients within 1e-5 of their largest
value; uint8 images within 1 step. GroupNorm at a large mean (10, std 1)
within 1e-4 of its largest value: both sides take flax's
E[x^2] - E[x]^2, whose cancellation turns the sums' different rounding
into an error of a few ulp(100) / var (read: up to 3.7e-5 of the largest
value, over three seeds).

bf16 (``compute_dtype=bfloat16``, the preset's): the same weights and
input through flax with ``dtype=bfloat16`` and the port in bf16. The port
takes JAX's explicit casts and rounds each op where JAX's jaxpr rounds it
(GroupNorm and swish alone are held to that below). XLA on the CPU by
default keeps fp32 across a fusion's bf16 roundings
(``xla_allow_excess_precision``: in a VQResBlock it took GN's x - mean from
the conv's unrounded bias add and GN's moments from the rounded one), so
flax's apply is compiled with that off (``BF16_OPTIONS``) and rounds where
its program says. Then the two packages differ only where sums in another
order round apart, and a differing element moves the sums after it: read,
the stem conv and the first block's GN and conv bit-equal, 0.04% of the
first block's output differing, 44% of the encoder's. Codes: bf16 latents
differ by that noise, so a latent whose two nearest codewords are that
close may take either code; codes must agree wherever the gap between them
exceeds what the latents' difference can move it
(``chip_smoke._code_agreement``), and such latents must be most of them.
The port's module outputs are then taken with its quantizer pinned to
flax's codes (``pin_codes``), in bf16 and in fp32. Each module's output
(every GN, conv, VQResBlock and AttnBlock, the encoder, the decoder and
the reconstruction) in bf16 within CLOSER = 0.8 of the distance of the
port's fp32 output from flax's bf16 output, in the Euclidean norm: a port
that rounds where flax does sits nearer flax's bf16 output than its fp32
output does (read: 0 at the stem to 0.63 at the decoder's end), and a
model computed in fp32 reads 1.0 and fails. The codebook terms and
perplexity within 2^-6 relative, a few bf16 ulps of their inputs.
GroupNorm alone: y and dx within one bf16 ulp of their largest magnitude
(each rounds fp32 values that agree to ~1e-5, dx as JAX's VJP rounds it:
the direct and the statistics' path each rounded, then added in bf16),
dscale and dbias (fp32) as in fp32. Swish alone: y and dx bit-equal to
JAX's x * sigmoid(x) and its VJP, op by op in bf16.
"""

import importlib.util
import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from uig.models.vqgan import GN as JaxGN
from uig.models.vqgan import _swish as jax_swish
from uig.models.vqgan import VectorQuantizer as JaxVQ
from uig.models.vqgan import VQGANGenerator as JaxGenerator
from uig_torch.config import apply_overrides, get_preset
from uig_torch.convert import (flax_from_generator_state,
                               generator_state_from_flax, seeded_flax)
from uig_torch.models import generator_from_config
from uig_torch.models.layers import Conv
from uig_torch.models.vqgan import GN, VectorQuantizer, _swish, pin_codes

OVERRIDES = ["model.image_size=32", "data.load_size=32",
             "model.vq_base_features=16", "model.vq_channel_mults=(1,2)",
             "model.vq_embed_dim=8", "model.vq_codebook_size=32",
             "model.vq_attn_resolutions=(16,)", "model.compute_dtype=float32"]
REL = 1e-5
DATA_SEED = 0
MODULES = (
    [f"encoder.{n}" for n in ["Conv_0", "Conv_1", "Conv_2", "GN_0",
                              "AttnBlock_0", "AttnBlock_1"]
     + [f"VQResBlock_{i}" for i in range(6)]]
    + [f"decoder.{n}" for n in ["Conv_0", "Conv_1", "Conv_2", "GN_0",
                                "AttnBlock_0", "AttnBlock_1"]
       + [f"VQResBlock_{i}" for i in range(6)]]
    + ["encoder", "decoder"])


RTOL_BF16 = 2.0 ** -6
CLOSER = 0.8
# XLA's backend at optimization level 0: the same bits, compiled faster
FP32_OPTIONS = {"xla_backend_optimization_level": 0}
BF16_OPTIONS = {**FP32_OPTIONS, "xla_allow_excess_precision": False}


def _cfg():
    return apply_overrides(get_preset("vqgan512"), OVERRIDES)


def _jax_generator(dtype=jnp.float32):
    m = _cfg().model
    return JaxGenerator(
        base_features=m.vq_base_features, channel_mults=m.vq_channel_mults,
        embed_dim=m.vq_embed_dim, codebook_size=m.vq_codebook_size,
        attn_resolutions=m.vq_attn_resolutions, attn_impl="pallas",
        dtype=dtype)


def _apply_with_hooks(model, x):
    """(recon, vq, {module name: output}) of the port's ``model`` on x."""
    outs, hooks = {}, []
    for name, mod in model.named_modules():
        if name in MODULES:
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: outs.__setitem__(name, o)))
    with torch.no_grad():
        recon, vq = model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return recon, vq, outs


def _jax_apply(gen, params, x, options=None):
    """(recon, vq, {module name: output}) of flax ``gen``, one jitted apply
    with ``capture_intermediates``, compiled with XLA ``options``."""
    fn = jax.jit(lambda p, x: gen.apply(
        p, x, capture_intermediates=True, mutable=["intermediates"]))
    x = jnp.asarray(x)
    if options:
        fn = fn.lower(params, x).compile(compiler_options=options)
    (recon, vq), inter = fn(params, x)
    inter = {".".join(k[:-1]): np.asarray(v[0], np.float32) for k, v in
             traverse_util.flatten_dict(inter["intermediates"]).items()
             if k[-1] == "__call__" and ".".join(k[:-1]) in MODULES}
    return recon, vq, inter


def _to_jax(flat: dict) -> dict:
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{what}: {err}"


@pytest.fixture(scope="module")
def run():
    model = generator_from_config(_cfg().model)
    flat = seeded_flax(model, 0)
    rng = np.random.default_rng(1)
    for k in flat:
        if k.endswith(("/bias", "/scale")):
            flat[k] = flat[k] + 0.1 * rng.standard_normal(
                flat[k].shape).astype(np.float32)
    model.load_state_dict(generator_state_from_flax(flat, model))
    raw = np.random.default_rng(DATA_SEED).integers(0, 256, (2, 32, 32, 3),
                                                    dtype=np.uint8)
    x = raw.astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)
    gen = _jax_generator()
    params = _to_jax(flat)
    recon, vq, inter = _jax_apply(gen, params, x, FP32_OPTIONS)
    codes = np.asarray(vq.codes)
    decoded = np.asarray(jax.jit(lambda p, c: gen.apply(
        p, c, method=JaxGenerator.decode_codes))(params, jnp.asarray(codes)))

    p_recon, p_vq, outs = _apply_with_hooks(model, x)
    with torch.no_grad():
        p_decoded = model.decode_codes(torch.from_numpy(codes.copy()))
        p_enc = model.encode(torch.from_numpy(x))
    return {"flat": flat, "params": params, "raw": raw, "x": x,
            "jax": {"recon": np.asarray(recon), "vq": vq, "inter": inter,
                    "decoded": decoded},
            "port": {"recon": p_recon, "vq": p_vq, "inter": outs,
                     "decoded": p_decoded, "encode": p_enc}}


@pytest.mark.parametrize("name", MODULES)
def test_module_outputs(run, name):
    _close(run["port"]["inter"][name].numpy(), run["jax"]["inter"][name], name)


def test_generator_and_encode(run):
    jvq, pvq = run["jax"]["vq"], run["port"]["vq"]
    np.testing.assert_array_equal(pvq.codes.numpy(), np.asarray(jvq.codes))
    assert pvq.codes.dtype == torch.int32
    assert len(np.unique(np.asarray(jvq.codes))) > 8  # the quantizer works
    _close(run["port"]["recon"].numpy(), run["jax"]["recon"], "recon")
    _close(pvq.quantized.numpy(), np.asarray(jvq.quantized), "quantized")
    for k in ("codebook_loss", "commitment_loss", "perplexity"):
        np.testing.assert_allclose(float(getattr(pvq, k)),
                                   float(getattr(jvq, k)), rtol=REL)
    enc = run["port"]["encode"]
    for a, b in zip(enc, pvq):
        assert torch.equal(a, b)


def test_decode_codes(run):
    _close(run["port"]["decoded"].numpy(), run["jax"]["decoded"],
           "decode_codes")


def test_translator_reconstructs_and_decodes(run, tmp_path):
    from uig_torch.serving import Translator

    path = tmp_path / "g.npz"
    np.savez(path, **run["flat"])
    tr = Translator("vqgan512", str(path), batch_size=4, device="cpu",
                    overrides=OVERRIDES)
    assert tr.meta["kind"] == "vqgan"

    def u8(y):
        return np.clip(np.round((y + 1.0) * 127.5), 0, 255).astype(np.int16)

    got = tr(run["raw"])
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got - u8(run["jax"]["recon"])).max() <= 1
    codes = np.asarray(run["jax"]["vq"].codes)
    dec = tr.decode_codes(codes)
    assert np.abs(dec - u8(run["jax"]["decoded"])).max() <= 1
    with pytest.raises(ValueError):
        tr.decode_codes(codes + 32)


def test_names_mirror_flax_and_round_trip(run):
    init = jax.eval_shape(_jax_generator().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))
    want = {"/".join(k): v.shape for k, v in
            traverse_util.flatten_dict(init).items()}
    flat = run["flat"]
    assert {k: v.shape for k, v in flat.items()} == want
    back = flax_from_generator_state(generator_state_from_flax(flat))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_seeded_weights_follow_flax_initializers():
    model = generator_from_config(get_preset("vqgan512").model)
    flat = seeded_flax(model, 3)
    k = flat["params/encoder/VQResBlock_0/Conv_0/kernel"]  # 3x3x128x128
    assert abs(k.std() * np.sqrt(9 * 128) - 1.0) < 0.02
    assert np.abs(k).max() <= 2.0 / np.sqrt(9 * 128) / 0.87962566103423978
    cb = flat["params/quantizer/codebook"]
    assert np.abs(cb).max() <= np.sqrt(3.0 / 1024) and cb.std() > 0.03
    assert not flat["params/decoder/Conv_0/bias"].any()
    assert (flat["params/decoder/GN_0/GroupNorm_0/scale"] == 1).all()


@pytest.mark.parametrize("shift", [0.0, 10.0], ids=["centred", "mean10"])
def test_group_norm_matches_flax(shift):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 4, 5, 64)) + shift).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    params = {"params": {"GroupNorm_0": {"scale": jnp.asarray(scale),
                                         "bias": jnp.asarray(bias)}}}
    y, vjp = jax.vjp(lambda x, p: JaxGN().apply(p, x), jnp.asarray(x), params)
    dx, dp = vjp(jnp.asarray(dy))
    gn = GN(64)
    gn.GroupNorm_0.scale.data = torch.from_numpy(scale)
    gn.GroupNorm_0.bias.data = torch.from_numpy(bias)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = gn(xt)
    got = torch.autograd.grad(yt, [xt, gn.GroupNorm_0.scale,
                                   gn.GroupNorm_0.bias], torch.from_numpy(dy))
    rel = REL if shift == 0 else 1e-4
    _close(yt.detach().numpy(), y, "y", rel)
    for g, w, what in zip(got, (dx, dp["params"]["GroupNorm_0"]["scale"],
                                dp["params"]["GroupNorm_0"]["bias"]),
                          ("dx", "dscale", "dbias")):
        _close(g.numpy(), w, what, rel)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_stride2_same_padding(hw):
    """flax's SAME pads a 3x3 stride-2 conv (0, 1) on an even plane; torch's
    symmetric padding=1 gives another, plausible-looking map."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, *hw, 16)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 16, 8))).astype(np.float32)
    b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    conv = fnn.Conv(8, (3, 3), strides=(2, 2))
    want = np.asarray(conv.apply({"params": {"kernel": w, "bias": b}},
                                 jnp.asarray(x)))
    port = Conv(16, 8, 3, stride=2)
    port.kernel.data, port.bias.data = torch.from_numpy(w), torch.from_numpy(b)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        sym = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b),
            stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    _close(got, want, "conv")
    if hw[0] % 2 == 0:
        assert np.abs(sym - want).max() > 0.1


def test_vector_quantizer_matches_flax():
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    vq = JaxVQ(codebook_size=16, embed_dim=4)
    params = vq.init(jax.random.PRNGKey(1), jnp.asarray(z))
    cb = np.asarray(params["params"]["codebook"])
    g = rng.standard_normal(z.shape).astype(np.float32)

    def jloss(z, p):
        out = vq.apply(p, z)
        return (jnp.sum(out.quantized * g) + 3.0 * out.codebook_loss
                + 5.0 * out.commitment_loss), out

    (_, jout), (jdz, jdp) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(z), params)
    port = VectorQuantizer(16, 4)
    port.codebook.data = torch.from_numpy(cb.copy())
    zt = torch.from_numpy(z).requires_grad_(True)
    out = port(zt)
    loss = (torch.sum(out.quantized * torch.from_numpy(g))
            + 3.0 * out.codebook_loss + 5.0 * out.commitment_loss)
    dz, dcb = torch.autograd.grad(loss, [zt, port.codebook])
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(jout.codes))
    _close(out.quantized.detach().numpy(), jout.quantized, "quantized")
    for k in ("codebook_loss", "commitment_loss", "perplexity"):
        np.testing.assert_allclose(float(getattr(out, k).detach()),
                                   float(getattr(jout, k)), rtol=REL)
    _close(dz.numpy(), jdz, "dz")
    _close(dcb.numpy(), jdp["params"]["codebook"], "dcodebook")
    emb = port.embed(out.codes)  # z + (e - z) is e up to rounding
    _close(emb.detach().numpy(), out.quantized.detach().numpy(), "embed")


def test_kind_dispatch_and_refusals():
    cfg = _cfg()
    with pytest.raises(NotImplementedError, match="remat"):
        generator_from_config(apply_overrides(cfg, ["model.remat=blocks"]).model)
    with pytest.raises(NotImplementedError, match="kind"):
        generator_from_config(apply_overrides(cfg, ["model.kind=unit"]).model)
    assert generator_from_config(apply_overrides(
        cfg, ["model.eval_dtype=bfloat16"]).model).dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="float32"):
        generator_from_config(
            apply_overrides(cfg, ["model.eval_dtype=float16"]).model)


# ------------------------------------------------------------------ bf16 --


@pytest.fixture(scope="module")
def run16(run):
    """flax with dtype=bfloat16 and the port in bf16 on ``run``'s weights
    and input."""
    recon, vq, inter = _jax_apply(_jax_generator(jnp.bfloat16), run["params"],
                                  run["x"], BF16_OPTIONS)
    codes = torch.from_numpy(np.array(vq.codes))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # sums in one order from run to run
    out = {"jax": {"recon": np.asarray(recon, np.float32), "vq": vq,
                   "inter": inter}}
    for dt in ("bfloat16", "float32"):
        cfg = apply_overrides(_cfg(), [f"model.compute_dtype={dt}"])
        model = generator_from_config(cfg.model, "compute_dtype")
        model.load_state_dict(generator_state_from_flax(run["flat"], model))
        if dt == "bfloat16":  # the port's own codes
            out["vq"] = _apply_with_hooks(model, run["x"])[1]
        with pin_codes(model.quantizer, codes):
            p_recon, _, outs = _apply_with_hooks(model, run["x"])
        out[dt] = {"recon": p_recon, "inter": outs}
    torch.set_num_threads(threads)
    return out


def _closer_than_fp32(got16, got32, want, what, capsys):
    """The port's bf16 output within CLOSER times the distance of its fp32
    output from flax's bf16 output, in the Euclidean norm."""
    assert got16.dtype == torch.bfloat16, what
    d16 = np.linalg.norm(got16.float().numpy().astype(np.float64) - want)
    d32 = np.linalg.norm(got32.numpy().astype(np.float64) - want)
    with capsys.disabled():
        print(f"\n{what}: bf16 gap / fp32 gap {d16 / d32:.3f}")
    assert d16 <= CLOSER * d32, f"{what}: bf16 gap {d16:.4g} > {CLOSER} x " \
        f"fp32 gap {d32:.4g}"


@pytest.mark.parametrize("name", MODULES)
def test_bf16_module_outputs(run16, name, capsys):
    _closer_than_fp32(run16["bfloat16"]["inter"][name],
                      run16["float32"]["inter"][name],
                      run16["jax"]["inter"][name], name, capsys)


def _code_agreement():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._code_agreement


def test_bf16_generator(run, run16, capsys):
    jvq, pvq = run16["jax"]["vq"], run16["vq"]
    agree = _code_agreement()(
        run16["bfloat16"]["inter"]["encoder"],
        torch.from_numpy(run16["jax"]["inter"]["encoder"]), pvq.codes,
        torch.from_numpy(np.array(jvq.codes)),
        torch.from_numpy(run["flat"]["params/quantizer/codebook"]))
    with capsys.disabled():
        print(f"\nbf16 codes: {agree}")
    assert agree["differ_checked"] == 0
    assert agree["checked"] > agree["latents"] // 2
    assert pvq.quantized.dtype == torch.bfloat16
    _closer_than_fp32(run16["bfloat16"]["recon"], run16["float32"]["recon"],
                      run16["jax"]["recon"], "recon", capsys)
    for k in ("codebook_loss", "commitment_loss", "perplexity"):
        assert getattr(pvq, k).dtype == torch.float32
        np.testing.assert_allclose(float(getattr(pvq, k)),
                                   float(getattr(jvq, k)), rtol=RTOL_BF16)


@pytest.mark.parametrize("shift", [0.0, 10.0], ids=["centred", "mean10"])
def test_group_norm_bf16_matches_flax(shift):
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((2, 4, 5, 64)) + shift)
                         .astype(np.float32)).to(torch.bfloat16)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)
                          ).to(torch.bfloat16)
    params = {"params": {"GroupNorm_0": {"scale": jnp.asarray(scale),
                                         "bias": jnp.asarray(bias)}}}
    y, vjp = jax.vjp(lambda x, p: JaxGN(jnp.bfloat16).apply(p, x),
                     jnp.asarray(x.float().numpy(), jnp.bfloat16), params)
    dx, dp = vjp(jnp.asarray(dy.float().numpy(), jnp.bfloat16))
    gn = GN(64, torch.bfloat16)
    gn.GroupNorm_0.scale.data = torch.from_numpy(scale)
    gn.GroupNorm_0.bias.data = torch.from_numpy(bias)
    xt = x.clone().requires_grad_(True)
    yt = gn(xt)
    got = torch.autograd.grad(yt, [xt, gn.GroupNorm_0.scale,
                                   gn.GroupNorm_0.bias], dy)
    assert yt.dtype == got[0].dtype == torch.bfloat16
    for g, w, what in ((yt.detach(), y, "y"), (got[0], dx, "dx")):
        w = np.asarray(w, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        err = np.abs(g.float().numpy() - w).max()
        assert err <= ulp, f"{what}: {err / ulp} bf16 ulps"
    rel = REL if shift == 0 else 1e-4
    for g, w, what in zip(got[1:], (dp["params"]["GroupNorm_0"]["scale"],
                                    dp["params"]["GroupNorm_0"]["bias"]),
                          ("dscale", "dbias")):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, what, rel)


def test_swish_bf16_matches_jax():
    x = np.random.default_rng(6).standard_normal(4096).astype(np.float32) * 4
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jax.jit(jax_swish)(jnp.asarray(xt.float().numpy(),
                                                     jnp.bfloat16)),
                      np.float32)
    got = _swish(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_swish_bf16_vjp_matches_jax():
    """dx bit-equal to JAX's VJP of x * sigmoid(x) in bf16, op by op
    (eager, so that each op rounds), the bf16 swish keeping only x."""
    rng = np.random.default_rng(7)
    xt = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 4
                          ).to(torch.bfloat16).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                          ).to(torch.bfloat16)
    y, vjp = jax.vjp(jax_swish, jnp.asarray(xt.detach().float().numpy(),
                                             jnp.bfloat16))
    want, = vjp(jnp.asarray(dy.float().numpy(), jnp.bfloat16))
    got = _swish(xt)
    saved = got.grad_fn.saved_tensors
    assert len(saved) == 1 and torch.equal(saved[0], xt)  # x alone kept
    dx, = torch.autograd.grad(got, xt, dy)
    assert dx.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(y, np.float32))
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(want, np.float32))
