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
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from uig.models.vqgan import GN as JaxGN
from uig.models.vqgan import VectorQuantizer as JaxVQ
from uig.models.vqgan import VQGANGenerator as JaxGenerator
from uig_torch.config import apply_overrides, get_preset
from uig_torch.convert import (flax_from_generator_state,
                               generator_state_from_flax, seeded_flax)
from uig_torch.models import generator_from_config
from uig_torch.models.layers import Conv
from uig_torch.models.vqgan import GN, VectorQuantizer

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


def _cfg():
    return apply_overrides(get_preset("vqgan512"), OVERRIDES)


def _jax_generator():
    m = _cfg().model
    return JaxGenerator(
        base_features=m.vq_base_features, channel_mults=m.vq_channel_mults,
        embed_dim=m.vq_embed_dim, codebook_size=m.vq_codebook_size,
        attn_resolutions=m.vq_attn_resolutions, attn_impl="pallas")


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
    (recon, vq), inter = jax.jit(lambda p, x: gen.apply(
        p, x, capture_intermediates=True, mutable=["intermediates"]))(
            params, jnp.asarray(x))
    inter = {".".join(k[:-1]): np.asarray(v[0]) for k, v in
             traverse_util.flatten_dict(inter["intermediates"]).items()
             if k[-1] == "__call__" and ".".join(k[:-1]) in MODULES}
    codes = np.asarray(vq.codes)
    decoded = np.asarray(jax.jit(lambda p, c: gen.apply(
        p, c, method=JaxGenerator.decode_codes))(params, jnp.asarray(codes)))

    outs, hooks = {}, []
    for name, mod in model.named_modules():
        if name in MODULES:
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: outs.__setitem__(name, o)))
    with torch.no_grad():
        p_recon, p_vq = model(torch.from_numpy(x))
        p_decoded = model.decode_codes(torch.from_numpy(codes.copy()))
        p_enc = model.encode(torch.from_numpy(x))
    for h in hooks:
        h.remove()
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
    with pytest.raises(NotImplementedError, match="float32"):
        generator_from_config(
            apply_overrides(cfg, ["model.eval_dtype=bfloat16"]).model)
