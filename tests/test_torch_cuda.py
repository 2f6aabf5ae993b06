"""The port's CUDA kernels on the card against their plain PyTorch versions,
at ragged shapes the main path does not reach (tiles cut at every edge,
channel counts that fill no tile), plus the guards a CUDA tensor meets.

Needs an NVIDIA card: every test is marked ``cuda`` and skips without one.
This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: fp32 sums taken in another order than the plain version's;
outputs are O(1) and the longest sum has 49 * 24 terms.
"""

import numpy as np
import pytest
import torch

from uig_torch.kernels import (conv3_in_act, conv3_in_act_reference, conv7,
                               conv7_reference, instance_norm,
                               instance_norm_reference)
from uig_torch.serving import exact_fp32

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with exact_fp32():
        yield torch.device("cuda", 0)


def _randn(dev, *shape, scale=1.0, shift=0.0, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(dev)


def _close(kernel_out, plain_out):
    torch.cuda.synchronize()
    err = (kernel_out - plain_out).abs().max().item()
    assert err <= ATOL, err


@pytest.mark.parametrize("shape", [(3, 13, 17, 36), (1, 1, 5, 4),
                                   (2, 64, 64, 256)])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm(dev, shape, relu):
    c = shape[-1]
    x = _randn(dev, *shape, scale=2.0, shift=0.5)
    g = _randn(dev, c, scale=0.2, shift=1.0, seed=1)
    b = _randn(dev, c, scale=0.2, seed=2)
    before = instance_norm.launches
    y = instance_norm(x, g, b, relu=relu)
    assert instance_norm.launches == before + 1
    _close(y, instance_norm_reference(x, g, b, relu=relu))
    assert torch.equal(y, instance_norm(x, g, b, relu=relu))  # no atomics


@pytest.mark.parametrize("shape,f", [((2, 11, 13, 20), 12), ((1, 2, 2, 4), 4),
                                     ((1, 16, 16, 8), 132)])
@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3_in_act(dev, shape, f, pad_mode, relu):
    c = shape[-1]
    x = _randn(dev, *shape)
    w = _randn(dev, 3, 3, c, f, scale=0.1, seed=1)
    b, g, be = (_randn(dev, f, scale=0.1, seed=2),
                _randn(dev, f, scale=0.2, shift=1.0, seed=3),
                _randn(dev, f, scale=0.2, seed=4))
    before = conv3_in_act.launches
    y = conv3_in_act(x, w, b, g, be, relu=relu, pad_mode=pad_mode)
    assert conv3_in_act.launches == before + 1
    _close(y, conv3_in_act_reference(x, w, b, g, be, relu=relu,
                                     pad_mode=pad_mode))
    assert torch.equal(y, conv3_in_act(x, w, b, g, be, relu=relu,
                                       pad_mode=pad_mode))


@pytest.mark.parametrize("shape,cout", [((2, 37, 45, 24), 3), ((1, 4, 4, 8), 1),
                                        ((1, 9, 33, 16), 4)])
@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_conv7(dev, shape, cout, pad_mode):
    cin = shape[-1]
    x = _randn(dev, *shape)
    w = _randn(dev, 7, 7, cin, cout, scale=0.05, seed=1)
    b = _randn(dev, cout, scale=0.1, seed=2)
    before = conv7.launches
    y = conv7(x, w, b, pad_mode)
    assert conv7.launches == before + 1
    _close(y, conv7_reference(x, w, b, pad_mode))
    _close(conv7(x, w, None, pad_mode), conv7_reference(x, w, None, pad_mode))


def test_cuda_operands_are_checked_not_bypassed(dev):
    x = _randn(dev, 1, 8, 8, 8)
    g = torch.ones(8, device=dev)
    with pytest.raises(TypeError, match="float32"):
        instance_norm(x.double(), g.double(), g.double())
    with pytest.raises(ValueError, match="contiguous"):
        instance_norm(x.permute(0, 2, 1, 3), g, g)
    with pytest.raises(ValueError, match="several devices"):
        instance_norm(x, g.cpu(), g.cpu())
    with pytest.raises(ValueError, match="multiple of 4"):
        instance_norm(_randn(dev, 1, 4, 4, 6), torch.ones(6, device=dev),
                      torch.ones(6, device=dev))
    with pytest.raises(ValueError, match="Cout"):
        conv7(x, _randn(dev, 7, 7, 8, 5), None)
