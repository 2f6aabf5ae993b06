"""uig_torch.convert and uig_torch.config: flax generator weights, whole JAX
CycleGAN train states and JAX config files cross into the port
unchanged."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from uig.config import PRESETS as JAX_PRESETS
from uig.config import config_to_dict as jax_config_to_dict
from uig.config import get_preset as jax_get_preset
from uig.models import ResNetGenerator as JaxGenerator
from uig_torch.config import config_to_dict, get_preset, load_config
from uig.models import PatchDiscriminator as JaxDisc
from uig_torch.convert import (flax_from_generator_state,
                               generator_state_from_flax,
                               jax_flat_from_train_state, load_generator_npz,
                               train_state_from_jax_flat)
from uig_torch.models import PatchDiscriminator, ResNetGenerator
from uig_torch.train import CycleGANState


def _flax_flat(base=8, blocks=2, upsample="conv_transpose", seed=0):
    """A flax generator's flat parameters: the tree of its ``init``
    (traced, ``jax.eval_shape``), every leaf drawn with numpy so that a
    swapped key cannot pass by accident."""
    gen = JaxGenerator(base_features=base, n_res_blocks=blocks,
                       upsample=upsample)
    params = jax.eval_shape(gen.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 16, 16, 3)))
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}


@pytest.mark.parametrize("upsample", ["conv_transpose", "resize_conv"])
def test_flax_to_port_and_back_is_bit_equal(upsample):
    flat = _flax_flat(upsample=upsample)
    model = ResNetGenerator(base_features=8, n_res_blocks=2, upsample=upsample)
    model.load_state_dict(generator_state_from_flax(flat, model), strict=True)
    back = flax_from_generator_state(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_tree_layout():
    flat = _flax_flat(blocks=2)
    n = 2
    keys = set(flat)
    for k in ("layers_0/kernel", "layers_1/scale", "layers_3/kernel",
              "layers_4/bias", "layers_6/kernel", "layers_7/scale",
              f"layers_{9}/PadConv_0/kernel", f"layers_{9}/InstanceNorm_1/bias",
              f"layers_{9 + n}/ConvTranspose_0/kernel",
              f"layers_{12 + n}/ConvTranspose_0/bias",
              f"layers_{15 + n}/kernel"):
        assert "params/" + k in keys, k


def test_missing_extra_and_misshaped_keys_raise():
    flat = _flax_flat()
    model = ResNetGenerator(base_features=8, n_res_blocks=2)
    missing = dict(flat)
    del missing["params/layers_1/scale"]
    with pytest.raises(KeyError, match="layers_1.scale"):
        generator_state_from_flax(missing, model)
    extra = dict(flat, **{"params/layers_99/kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="layers_99"):
        generator_state_from_flax(extra, model)
    bad = dict(flat, **{"params/layers_1/scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="layers_1.scale"):
        generator_state_from_flax(bad, model)
    with pytest.raises(KeyError, match="params/"):
        generator_state_from_flax({"layers_0/kernel": np.zeros(1)}, model)


def test_npz_round_trip(tmp_path):
    flat = _flax_flat()
    path = tmp_path / "g.npz"
    np.savez(path, **flat)
    got = load_generator_npz(str(path))
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_jax_config_json_loads_unchanged(name, tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(jax_config_to_dict(jax_get_preset(name))))
    assert config_to_dict(load_config(str(path))) == \
        jax_config_to_dict(jax_get_preset(name))
    assert config_to_dict(get_preset(name)) == \
        jax_config_to_dict(jax_get_preset(name))


def test_state_tensors_are_fp32_cpu():
    state = generator_state_from_flax(_flax_flat())
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in state.values())


def _jax_state_flat(seed=0):
    """A flat JAX-layout CycleGAN state (the keys of
    ``flax.serialization.to_state_dict``) with perturbed leaves, built
    without a trainer: generator and discriminator trees, two Adam states,
    pools, step, key."""
    rng = np.random.default_rng(seed)
    # the trees' leaf shapes, traced (``jax.eval_shape``): every leaf value
    # below is drawn from ``rng``
    g = traverse_util.flatten_dict(jax.eval_shape(
        JaxGenerator(base_features=8, n_res_blocks=1).init,
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3))), sep="/")
    d = traverse_util.flatten_dict(jax.eval_shape(
        JaxDisc(base_features=8, n_layers=2).init,
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3))), sep="/")

    def rand(shape):
        return rng.standard_normal(shape).astype(np.float32)

    flat = {}
    for tree, nets, leaves in (("g_params", ("a2b", "b2a"), g),
                               ("d_params", ("a", "b"), d),
                               ("ema", ("a2b", "b2a"), g)):
        for net in nets:
            for k, v in leaves.items():
                flat[f"{tree}/{net}/{k}"] = rand(v.shape)
    for opt, nets, leaves in (("g_opt", ("a2b", "b2a"), g),
                              ("d_opt", ("a", "b"), d)):
        for mom in ("mu", "nu"):
            for net in nets:
                for k, v in leaves.items():
                    flat[f"{opt}/0/0/{mom}/{net}/{k}"] = rand(v.shape)
        flat[f"{opt}/0/0/count"] = np.int32(5)
        flat[f"{opt}/0/1/count"] = np.int32(5)
    for pool in ("pool_a", "pool_b"):
        flat[pool + "/buffer"] = rand((3, 16, 16, 3))
        flat[pool + "/count"] = np.int32(3)
    flat.update(step=np.int32(5), rng=np.array([0, 7], np.uint32),
                ada_p=np.float32(0.0))
    return flat


def test_train_state_round_trip_and_names():
    flat = _jax_state_flat()
    state = train_state_from_jax_flat(flat, CycleGANState, seed=3)
    assert state.step == 5 and state.seed == 3
    assert state.g_opt.count == state.d_opt.count == 5
    assert state.pool_a.count == 3
    g_names = set(ResNetGenerator(base_features=8,
                                  n_res_blocks=1).state_dict())
    d_names = set(PatchDiscriminator(8, 2).state_dict())
    for tree, names in ((state.g_params, g_names), (state.ema, g_names),
                        (state.g_opt.mu, g_names), (state.d_params, d_names),
                        (state.d_opt.nu, d_names)):
        for sub in tree.values():
            assert set(sub) == names
    back = jax_flat_from_train_state(state)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the inverse copies: a later in-place step leaves it untouched
    state.g_params["a2b"]["layers_0.kernel"].add_(1.0)
    np.testing.assert_array_equal(back["g_params/a2b/params/layers_0/kernel"],
                                  flat["g_params/a2b/params/layers_0/kernel"])


def test_train_state_checks_counts_and_keys():
    flat = _jax_state_flat()
    bad = dict(flat, **{"g_opt/0/1/count": np.int32(4)})
    with pytest.raises(ValueError, match="schedule count"):
        train_state_from_jax_flat(bad, CycleGANState)
    bad = dict(flat, **{"g_params/a2b/layers_0/kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="params/"):
        train_state_from_jax_flat(bad, CycleGANState)
