"""uig_torch.convert and uig_torch.config: flax generator weights and JAX
config files cross into the port unchanged."""

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
from uig_torch.convert import (flax_from_generator_state,
                               generator_state_from_flax, load_generator_npz)
from uig_torch.models import ResNetGenerator


def _flax_flat(base=8, blocks=2, upsample="conv_transpose", seed=0):
    gen = JaxGenerator(base_features=base, n_res_blocks=blocks,
                       upsample=upsample)
    params = gen.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)))
    # perturb every leaf so that a swapped key cannot pass by accident
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32)
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
