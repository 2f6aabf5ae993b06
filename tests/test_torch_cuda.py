"""The port's CUDA kernels on the card against their plain PyTorch versions,
at ragged shapes the main path does not reach (tiles cut at every edge,
channel counts that fill no tile), plus the guards a CUDA tensor meets; the
autograd functions on the card against autograd of their plain versions;
and repeat runs of the reductions, which must be bit-equal.

Needs an NVIDIA card: every test is marked ``cuda`` and skips without one.
This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: fp32 sums taken in another order than the plain version's;
outputs are O(1) and the longest sum has 9 * 256 terms (the fused conv3+IN
at the path shape, products in the three-term TF32 split) (1e-4). Sums over
a whole plane or batch (dgamma, dbeta, dw) hold to 1e-4 relative to their
largest value. The augment kernel is bit-equal (the same two roundings in
the same order). The norm backward takes the statistics its forward kept,
both sides the same ones; with a fused ReLU it is compared where the
recomputed pre-activation is at least 1e-4 from 0: at the kink either side
is right.
Attention: the output and dq/dk/dv within 1e-5 of their largest value (fp32
softmax sums over at most 300 keys in another order), the log-sum-exp
within 1e-5. K4s (the 3x3 stride-2 conv and the VALID conv): within 1e-5 of
the largest value (sums over at most 9 * 36 terms, or the batch's pixels);
its fp32 forward, dgrad and wgrad, in the three-term TF32 split, are held
to the same 1e-5 at the path's widths and at ragged VALID shapes, and the
forward's error from float64 to at most twice the plain version's. The
7x7 head's fp32 forward, in the same split, is held to 1e-4 and its error
from float64 to at most twice the plain version's; its fp32 input and
weight gradients, in the split too, to 1e-4 (dw relative to its largest
value) and to at most twice the larger of the plain version's error from
float64 and the split's floor, 2^-22.

bf16: every kernel against its plain version in bf16 (both sum in fp32
from the same bf16 values and round once, in another order) within 1 bf16
ulp of the plain output's largest magnitude, 2^(floor(log2 M) - 7); the
fused conv3+IN within 2, since it rounds twice in series; the norm
backward's dgamma/dbeta (fp32) within 1e-4 relative. The bf16 attention
kernels are also held bit-equal to the fp32 kernels on the widened inputs.
"""

import copy
import os
import re

import numpy as np
import pytest
import torch

from uig_torch import kernels as K
from uig_torch.kernels import (attention, attention_bwd,
                               attention_bwd_reference, attention_fwd,
                               attention_reference, augment_batch,
                               augment_batch_reference,
                               conv3_in_act, conv3_in_act_reference, conv3s2,
                               conv3s2_act, conv3s2_dgrad,
                               conv3s2_dgrad_reference, conv3s2_reference,
                               conv3s2_wgrad, conv3s2_wgrad_reference, conv7,
                               conv7_act, conv7_dgrad, conv7_dgrad_reference,
                               conv7_reference, conv7_wgrad,
                               conv7_wgrad_reference, conv_core,
                               conv_core_reference, instance_norm,
                               instance_norm_act, instance_norm_bwd,
                               instance_norm_bwd_reference,
                               instance_norm_reference)
from uig_torch.kernels import norm
from uig_torch.kernels.norm import _instance_norm_fwd
from uig_torch.kernels.reflect import reflect_fold, reflect_pad
from uig_torch.serving import exact_fp32

# fit refuses a process whose CUDA started before cuBLAS's fixed workspace
# was set (test_fit_resume_is_byte_identical): set it before the first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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


def _randn_dev(dev, *shape, scale=1.0, shift=0.0, seed=0):
    """Drawn on the card: the path's planes, up to 268 MB."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev) * scale + shift


def _in_fwd_case(dev, shape, dt, relu, plan=None):
    """K2f (by its plan, or by ``plan``) against the plain version: y within
    ATOL (fp32) or 1 bf16 ulp, the statistics within 1e-5 of their largest
    value; a repeat bit-equal."""
    c = shape[-1]
    x = _randn_dev(dev, *shape, scale=2.0, shift=0.5).to(dt)
    g = _randn_dev(dev, c, scale=0.2, shift=1.0, seed=1)
    b = _randn_dev(dev, c, scale=0.2, seed=2)

    def run():
        if plan is None:
            return _instance_norm_fwd(x, g, b, 1e-5, relu)
        return norm._fwd_launch(x, g, b, 1e-5, relu, plan)

    y, stats = run()
    ry, rstats = norm._reference_fwd(x, g, b, 1e-5, relu)
    (_close if dt == torch.float32 else _ulps_close)(y, ry)
    _rel_close(stats, rstats, rel=1e-5)
    again = run()
    assert torch.equal(y, again[0]) and torch.equal(stats, again[1])


# K2f at the path's shapes: the generator's norms at 2B and B, the
# discriminator's; both dtypes, ReLU off and on
_IN_PATH = [(16, 256, 256, 64), (8, 256, 256, 64), (16, 128, 128, 128),
            (8, 64, 64, 256), (8, 32, 32, 256), (16, 31, 31, 512)]


@pytest.mark.parametrize("shape", _IN_PATH, ids=str)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_instance_norm_fwd_path(dev, shape, dt):
    for relu in (False, True):
        _in_fwd_case(dev, shape, dt, relu)


# The schedule: batch 1; five 8 MiB images in groups of two (the last group
# of one); pixels a run does not divide ((3, 13, 17, 36): 221 pixels in two
# runs; (1, 1, 5, 4)); bf16 rows of 72 and 8 bytes, which no 16-byte run
# fits (scalar channels); images too large to stay in the ring (67 MB and
# 23 MB: every run staged twice); and by hand, runs of one or two stages
# (19 runs an image, 6 images a group; a single reducer block).
@pytest.mark.parametrize("shape,dt,kw", [
    pytest.param((1, 256, 256, 64), torch.float32, {}, id="b1"),
    pytest.param((5, 128, 128, 128), torch.float32, {}, id="groups-of-2"),
    pytest.param((3, 13, 17, 36), torch.float32, {}, id="221px"),
    pytest.param((1, 1, 5, 4), torch.float32, {}, id="5px"),
    pytest.param((3, 13, 17, 36), torch.bfloat16, {}, id="bf16-72B-rows"),
    pytest.param((2, 9, 11, 4), torch.bfloat16, {}, id="bf16-8B-rows"),
    pytest.param((1, 512, 512, 64), torch.float32, {}, id="staged-twice"),
    pytest.param((2, 600, 600, 32), torch.bfloat16, {},
                 id="staged-twice-bf16"),
    pytest.param((7, 33, 35, 64), torch.float32, {"resident_stages": 1},
                 id="one-stage-runs"),
    pytest.param((6, 40, 40, 128), torch.bfloat16,
                 {"resident_stages": 1, "reducers": 1}, id="one-reducer")])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_fwd_schedule(dev, shape, dt, kw, relu):
    plan = None
    if kw:
        b, h, w, c = shape
        plan = norm.fwd_plan(b, h * w, c, 2 if dt == BF else 4,
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count, **kw)
        assert plan.resident and plan.chunks > 1 and plan.group < b
    _in_fwd_case(dev, shape, dt, relu, plan)


def _device_events(fn) -> list:
    """The names of the device events (kernels, memsets, copies) of one
    call of ``fn``, in order (``_captured``)."""
    return [e.name for e in _captured(fn)]


def _captured(fn) -> list:
    """The device events of one call of ``fn``, in order of start. The
    capture opens with a device spin of ~50 ms, waited for and dropped:
    torch.profiler loses the first device records of a capture, more of
    them the older the process (``tools/cupti_records.py``), and then
    loses the spin's. A capture that recorded nothing of ``fn`` is taken
    again, up to three calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000_000)  # ~50 ms at ~2 GHz
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "spin_kernel" not in e.name),
                        key=lambda e: e.time_range.start)
        if events:
            break
    return events


def test_instance_norm_fwd_is_one_launch(dev):
    """One kernel a call, no memset: the counters are reset by the kernel's
    last block."""
    for dt, shape in ((torch.float32, (8, 64, 64, 256)),
                      (BF, (16, 256, 256, 64)), (torch.float32, (2, 9, 9, 6))):
        x = _randn_dev(dev, *shape).to(dt)
        g = torch.ones(shape[-1], device=dev)
        instance_norm(x, g, g)  # the counters' buffer, once a stream
        names = _device_events(lambda: instance_norm(x, g, g, relu=True))
        assert len(names) == 1 and "in_fwd_kernel" in names[0], names


# The repair: K2f and K2b take every C (here none a multiple of 4 but C =
# 1, 3, 6 and 10 in both dtypes), forward and backward against the plain
# versions, repeats bit-equal. The backward is compared where the
# pre-activation is at least 1e-4 from the ReLU's kink.
@pytest.mark.parametrize("c", [1, 3, 6, 10])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_instance_norm_any_channels(dev, c, dt):
    x = _randn(dev, 3, 9, 11, c, scale=2.0, shift=0.5).to(dt)
    g = _randn(dev, c, scale=0.2, shift=1.0, seed=1)
    b = _randn(dev, c, scale=0.2, seed=2)
    dy = _randn(dev, 3, 9, 11, c, seed=3).to(dt)
    close = _close if dt == torch.float32 else _ulps_close
    for relu in (False, True):
        y, stats = _instance_norm_fwd(x, g, b, 1e-5, relu)
        close(y, instance_norm_reference(x, g, b, relu=relu))
        dx, dg, db = instance_norm_bwd(x, g, b, dy, stats, relu=relu)
        rdx, rdg, rdb = instance_norm_bwd_reference(x, g, b, dy, stats,
                                                    relu=relu)
        keep = torch.ones_like(x, dtype=torch.bool)
        if relu:
            xn = instance_norm_reference(x.float(), torch.ones_like(g),
                                         torch.zeros_like(b))
            keep = (xn * g + b).abs() >= 1e-4
        close(torch.where(keep, dx, 0.0), torch.where(keep, rdx, 0.0))
        _rel_close(dg, rdg)
        _rel_close(db, rdb)
        assert torch.equal(y, _instance_norm_fwd(x, g, b, 1e-5, relu)[0])
        again = instance_norm_bwd(x, g, b, dy, stats, relu=relu)
        assert all(torch.equal(u, v) for u, v in zip((dx, dg, db), again))


# The generator input's seed: every ReLU pre-activation of the CPU run at
# least KINK_MARGIN from 0 (at least 2.1e-4 for seed 2), so the card and
# the CPU take the same side of every kink
GEN6_SEED, KINK_MARGIN = 2, 1e-4


def _kink_margin(gen, x) -> float:
    """The least |pre-activation| of the generator's ReLUs (the fused
    IN + ReLU norms and each residual block's first conv + IN) on ``x``,
    from the plain versions on the CPU."""
    from uig_torch.kernels import conv3_in_act_reference
    from uig_torch.models.layers import InstanceNorm, ResnetBlock

    mins = []

    def norm_hook(m, args, kwargs, out):
        if kwargs.get("relu"):
            mins.append(instance_norm_reference(
                args[0], m.scale, m.bias, m.eps).abs().min().item())

    def block_hook(m, args, out):
        c0, n0 = m.PadConv_0, m.InstanceNorm_0
        mins.append(conv3_in_act_reference(
            args[0], c0.kernel, c0.bias, n0.scale, n0.bias, relu=False,
            eps=n0.eps, pad_mode=m.pad_mode).abs().min().item())

    hooks = [m.register_forward_hook(norm_hook, with_kwargs=True)
             for m in gen.modules() if isinstance(m, InstanceNorm)]
    hooks += [m.register_forward_hook(block_hook) for m in gen.modules()
              if isinstance(m, ResnetBlock)]
    with torch.no_grad():
        gen(x)
    for h in hooks:
        h.remove()
    return min(mins)


def test_generator_with_six_base_features(dev):
    """ResNetGenerator(base_features=6) trains on the card: its norms at C
    = 6 and 12 run K2f and K2b (the stride-2 conv from 6 channels runs the
    library conv, as in JAX). Forward and backward at (1, 32, 32, 3)
    against the same parameters on the CPU (plain versions): the output
    within 1e-4 of its largest value, every parameter gradient within 1e-3
    of the largest."""
    from uig_torch.models import ResNetGenerator

    torch.manual_seed(0)
    cpu = ResNetGenerator(base_features=6, n_res_blocks=1)
    x = _randn("cpu", 1, 32, 32, 3, seed=GEN6_SEED)
    ct = _randn("cpu", 1, 32, 32, 3, seed=GEN6_SEED + 1)
    assert _kink_margin(cpu, x) >= KINK_MARGIN
    card = copy.deepcopy(cpu).to(dev)
    K.reset_launch_counts()
    y = card(x.to(dev))
    grads = torch.autograd.grad(y, list(card.parameters()), ct.to(dev))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    # 5 norms (C = 6, 12, 24, 12, 6); the norm backward for each and for
    # the residual block's two conv + IN
    assert counts["instance_norm"] == 5 and counts["instance_norm_bwd"] == 7
    ry = cpu(x)
    rgrads = torch.autograd.grad(ry, list(cpu.parameters()), ct)
    _rel_close(y.cpu(), ry, rel=1e-4)
    top = max(t.abs().max().item() for t in rgrads)
    for u, v in zip(grads, rgrads):
        _rel_close(u.cpu(), v, rel=1e-3, scale=top)


# fp32 runs the conv on the tensor cores in the three-term TF32 split: C =
# 20, 4 and 8 fill part of a 32-channel K stage, (1, 9, 9, 36) one stage and
# a ragged one a tap, with 81 pixels of a 128-row tile; F = 12 and 4 fill
# part of a 128-wide N tile, 132 one and a ragged one; H = W = 2 mirrors
# onto one row; the path shape at batch 2, (2, 64, 64, 256) -> 256, wraps
# the 4-stage ring over its 72 K stages. Repeats are bit-equal.
@pytest.mark.parametrize("shape,f", [((2, 11, 13, 20), 12), ((1, 2, 2, 4), 4),
                                     ((1, 16, 16, 8), 132),
                                     ((1, 9, 9, 36), 36),
                                     ((2, 64, 64, 256), 256)])
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
    # every C is taken (C = 6: scalar channels), no plain fallback
    x6, g6 = _randn(dev, 1, 4, 4, 6), _randn(dev, 6, shift=1.0, seed=1)
    before = instance_norm.launches
    _close(instance_norm(x6, g6, g6), instance_norm_reference(x6, g6, g6))
    assert instance_norm.launches == before + 1
    with pytest.raises(ValueError, match="Cout"):
        conv7(x, _randn(dev, 7, 7, 8, 5), None)


def _rel_close(kernel_out, plain_out, rel=1e-4, scale=None):
    torch.cuda.synchronize()
    if scale is None:
        scale = max(plain_out.abs().max().item(), 1e-6)
    err = (kernel_out - plain_out).abs().max().item()
    assert err <= rel * scale, (err, scale)


def _augment_case(dev, shape, crop, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    b, h, w, _ = shape
    oy = torch.from_numpy(rng.integers(0, h - crop + 1, b))
    ox = torch.from_numpy(rng.integers(0, w - crop + 1, b))
    flip = torch.from_numpy(np.arange(b) % 2 == 0)  # flipped and unflipped
    return x, oy, ox, flip


# The path shape's rows are whole 16-byte pieces; (2, 9, 9, 1) and (3, 37,
# 41, 3) rows start and end off 16 bytes (scalar ends); 65 examples take two
# launches of at most 64, and the C entry refuses more than 64 at once.
@pytest.mark.parametrize("shape,crop", [((8, 286, 286, 3), 256),
                                        ((3, 37, 41, 3), 32),
                                        ((2, 9, 9, 1), 9),
                                        ((65, 12, 14, 3), 8)])
def test_augment(dev, shape, crop):
    x, oy, ox, flip = _augment_case(dev, shape, crop)
    before = augment_batch.launches
    y = augment_batch(x, oy, ox, flip, crop)
    assert augment_batch.launches == before + -(-shape[0] // 64)
    torch.cuda.synchronize()
    assert torch.equal(y, augment_batch_reference(x, oy, ox, flip, crop))
    assert torch.equal(y, augment_batch(x, oy, ox, flip, crop))
    if shape[0] > 64:
        meta = torch.zeros(3 * shape[0], dtype=torch.int32)
        with pytest.raises(RuntimeError, match="uig_augment failed"):
            K._build.launch("uig_augment", x, meta, y, shape[0], *shape[1:],
                            crop, False)


@pytest.mark.parametrize("shape", [(3, 13, 17, 36), (1, 1, 5, 4),
                                   (2, 31, 31, 512), (2, 64, 64, 64)])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_bwd(dev, shape, relu):
    c = shape[-1]
    x = _randn(dev, *shape, scale=2.0, shift=0.5)
    g = _randn(dev, c, scale=0.2, shift=1.0, seed=1)
    b = _randn(dev, c, scale=0.2, seed=2)
    dy = _randn(dev, *shape, seed=3)
    stats = _instance_norm_fwd(x, g, b, 1e-5, relu)[1]  # the forward's
    before = instance_norm_bwd.launches
    dx, dg, db = instance_norm_bwd(x, g, b, dy, stats, relu=relu)
    assert instance_norm_bwd.launches == before + 1
    rdx, rdg, rdb = instance_norm_bwd_reference(x, g, b, dy, stats,
                                                relu=relu)
    keep = torch.ones_like(x, dtype=torch.bool)
    if relu:
        xn = instance_norm_reference(x, torch.ones_like(g), torch.zeros_like(b))
        keep = (xn * g + b).abs() >= 1e-4
    _close(torch.where(keep, dx, 0.0), torch.where(keep, rdx, 0.0))
    _rel_close(dg, rdg)
    _rel_close(db, rdb)
    again = instance_norm_bwd(x, g, b, dy, stats, relu=relu)
    assert all(torch.equal(u, v) for u, v in zip((dx, dg, db), again))


_CONV7_SHAPES = [((2, 37, 45, 24), 3), ((1, 4, 4, 8), 1), ((1, 9, 33, 16), 4),
                 ((2, 16, 16, 36), 3)]


# the fp32 backward's shapes: those of both dtypes, then Cin 6 and 5 (not a
# multiple of 4: 4-byte source copies; odd: 4-byte dx stores), Cin 112 (two
# channel slices, the largest fp32 Cin) with Cout 4 (26-column strips),
# and a ragged plane of several tiles, strips and patches
_CONV7_FP32_SHAPES = _CONV7_SHAPES + [((2, 11, 23, 6), 3), ((1, 9, 17, 5), 2),
                                      ((1, 20, 70, 112), 4),
                                      ((1, 45, 150, 64), 3)]


# The three-term split's floor: an fp32 operand's hi + lo keeps it to 2^-22,
# and the tensor core truncates each partial's sum to fp32. At a few hundred
# terms a sum (the small shapes here) cuDNN's fp32 error from float64 falls
# below that floor (6.7e-8 to 1.0e-7 of the largest value on an H100), so
# the backward's error is held to twice the larger of the two.
_SPLIT_FLOOR = 2.0 ** -22


def _conv7_dgrad_fp64(dy, w, pad_mode):
    nb, h, wd, _ = dy.shape
    wt, dyn = w.double().permute(3, 2, 0, 1), dy.double().permute(0, 3, 1, 2)
    if pad_mode == "zeros":
        return torch.nn.grad.conv2d_input((nb, w.shape[2], h, wd), wt, dyn,
                                          padding=3).permute(0, 2, 3, 1)
    dxp = torch.nn.grad.conv2d_input((nb, w.shape[2], h + 6, wd + 6), wt,
                                     dyn)
    return reflect_fold(dxp.permute(0, 2, 3, 1), 3)


def _conv7_wgrad_fp64(x, dy, pad_mode):
    xd = reflect_pad(x.double(), 3) if pad_mode == "reflect" else x.double()
    dw = torch.nn.grad.conv2d_weight(
        xd.permute(0, 3, 1, 2), (dy.shape[3], x.shape[3], 7, 7),
        dy.double().permute(0, 3, 1, 2), padding=3 if pad_mode == "zeros"
        else 0)
    return dw.permute(2, 3, 1, 0)


@pytest.mark.parametrize("shape,cout", _CONV7_FP32_SHAPES)
@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_conv7_dgrad(dev, shape, cout, pad_mode):
    """K4d in fp32 (tf32x3, wgmma): within 1e-4 of the plain version, its
    error from float64 at most twice the plain version's (or the split's
    floor), repeats bit-equal, and only the split kernel launched."""
    b, h, w, cin = shape
    dy = _randn(dev, b, h, w, cout)
    wt = _randn(dev, 7, 7, cin, cout, scale=0.05, seed=1)
    before = conv7_dgrad.launches
    dx = conv7_dgrad(dy, wt, pad_mode)
    assert conv7_dgrad.launches == before + 1
    ref = conv7_dgrad_reference(dy, wt, pad_mode)
    _close(dx, ref)
    exact = _conv7_dgrad_fp64(dy, wt, pad_mode)
    assert _fp64_err(dx, exact) <= 2.0 * max(_fp64_err(ref, exact),
                                                _SPLIT_FLOOR)
    assert torch.equal(dx, conv7_dgrad(dy, wt, pad_mode))
    fns = _functions_run(lambda: conv7_dgrad(dy, wt, pad_mode))
    assert fns == {"conv7_dgrad_tf32_kernel"}, fns


@pytest.mark.parametrize("shape,cout", _CONV7_FP32_SHAPES)
@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_conv7_wgrad(dev, shape, cout, pad_mode):
    """K4w in fp32 (tf32x3, wgmma): within 1e-4 of the plain version's
    largest value, its error from float64 at most twice the plain
    version's (or the split's floor), repeats bit-equal (no atomics), and
    only the split kernel and its sum launched."""
    x = _randn(dev, *shape)
    dy = _randn(dev, *shape[:3], cout, seed=1)
    before = conv7_wgrad.launches
    dw = conv7_wgrad(x, dy, pad_mode)
    assert conv7_wgrad.launches == before + 1
    ref = conv7_wgrad_reference(x, dy, pad_mode)
    _rel_close(dw, ref)
    exact = _conv7_wgrad_fp64(x, dy, pad_mode)
    assert _fp64_err(dw, exact) <= 2.0 * max(_fp64_err(ref, exact),
                                                _SPLIT_FLOOR)
    assert torch.equal(dw, conv7_wgrad(x, dy, pad_mode))  # no atomics
    fns = _functions_run(lambda: conv7_wgrad(x, dy, pad_mode))
    assert fns == {"conv7_wgrad_tf32_kernel",
                   "conv7_wgrad_tf32_sum_kernel"}, fns


@pytest.mark.parametrize("cin", [6, 112])
def test_conv7_function_fp32_heads_the_forward_takes(dev, cin):
    """An fp32 head that PadConv routes to conv7_act (Cin 6, not a multiple
    of 4; Cin 112, the largest) runs its forward and its backward on the
    card and matches autograd of the plain version."""
    x = _randn(dev, 2, 12, 20, cin)
    w = _randn(dev, 7, 7, cin, 3, scale=0.05, seed=1)
    b = _randn(dev, 3, scale=0.1, seed=2)
    ct = _randn(dev, 2, 12, 20, 3, seed=3)
    before = (conv7.launches, conv7_dgrad.launches, conv7_wgrad.launches)
    got = _grads(lambda *a: conv7_act(*a, "reflect"), (x, w, b), ct)
    assert (conv7.launches, conv7_dgrad.launches, conv7_wgrad.launches) == \
        tuple(n + 1 for n in before)
    want = _grads(lambda *a: conv7_reference(*a, "reflect"), (x, w, b), ct)
    for u, v in zip(got, want):
        _rel_close(u, v)


def _grads(fn, inputs, ct):
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    return [out] + list(torch.autograd.grad(out, ins, ct))


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_function(dev, relu):
    x = _randn(dev, 2, 9, 11, 20, scale=2.0)
    g = _randn(dev, 20, scale=0.2, shift=1.0, seed=1)
    b = _randn(dev, 20, scale=0.2, seed=2)
    ct = _randn(dev, 2, 9, 11, 20, seed=3)
    got = _grads(lambda *a: instance_norm_act(*a, relu=relu), (x, g, b), ct)
    want = _grads(lambda *a: instance_norm_reference(*a, relu=relu),
                  (x, g, b), ct)
    for u, v in zip(got, want):
        _rel_close(u, v)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3_in_function(dev, pad_mode, relu):
    x = _randn(dev, 2, 10, 12, 16)
    w = _randn(dev, 3, 3, 16, 8, scale=0.1, seed=1)
    b, g, be = (_randn(dev, 8, scale=0.1, seed=2),
                _randn(dev, 8, scale=0.2, shift=1.0, seed=3),
                _randn(dev, 8, scale=0.2, seed=4))
    ct = _randn(dev, 2, 10, 12, 8, seed=5)
    got = _grads(lambda *a: conv3_in_act(*a, relu=relu, pad_mode=pad_mode),
                 (x, w, b, g, be), ct)
    want = _grads(lambda *a: conv3_in_act_reference(*a, relu=relu,
                                                    pad_mode=pad_mode),
                  (x, w, b, g, be), ct)
    # the conv bias feeds the norm: its true gradient is 0, and both sides
    # give rounding noise at the scale of the weight gradient
    for i, (u, v) in enumerate(zip(got, want)):
        _rel_close(u, v, scale=want[2].abs().max().item() if i == 3 else None)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_conv7_function(dev, pad_mode):
    x = _randn(dev, 2, 12, 20, 16)
    w = _randn(dev, 7, 7, 16, 3, scale=0.05, seed=1)
    b = _randn(dev, 3, scale=0.1, seed=2)
    ct = _randn(dev, 2, 12, 20, 3, seed=3)
    got = _grads(lambda *a: conv7_act(*a, pad_mode), (x, w, b), ct)
    want = _grads(lambda *a: conv7_reference(*a, pad_mode), (x, w, b), ct)
    for u, v in zip(got, want):
        _rel_close(u, v)


def test_reflect_pad_adjoint_is_deterministic(dev):
    x = _randn(dev, 2, 9, 7, 4)
    ct = _randn(dev, 2, 15, 13, 4, seed=1)
    torch.use_deterministic_algorithms(True)
    try:
        got = _grads(lambda t: reflect_pad(t, 3), (x,), ct)
        again = _grads(lambda t: reflect_pad(t, 3), (x,), ct)
    finally:
        torch.use_deterministic_algorithms(False)
    want = _grads(lambda t: torch.nn.functional.pad(
        t.permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect").permute(
            0, 2, 3, 1), (x,), ct)
    _close(got[1], want[1])
    assert torch.equal(got[1], again[1])


_ATTN_SHAPES = [(1, 37, 64), (2, 300, 256), (1, 70, 512), (3, 33, 36),
                (1, 1024, 512), (2, 129, 128), (9, 1024, 64)]


@pytest.mark.parametrize("shape", _ATTN_SHAPES, ids=str)
def test_attention_kernels(dev, shape):
    """Ragged N (tiles cut at the edge; N = 129 one row past two 64-row
    tiles), D in {64, 128, 256, 512} and one that fills no k8 step of the
    tensor cores, B = 1, and one full VQGAN grid (1, 1024, 512); the
    forward takes its keys in one range (one key tile: N = 37, 33; and at
    (9, 1024, 64), whose 9 x 16 q tiles fill the SMs) or in two (the
    others, on an H100's 132 SMs); repeats are bit-equal (no atomics)."""
    q, k, v, do = (_randn(dev, *shape, seed=i) for i in range(4))
    before = (attention_fwd.launches, attention_bwd.launches)
    o, lse, o32 = attention_fwd(q, k, v)
    assert o32 is o
    _rel_close(o, attention_reference(q, k, v), rel=1e-5)
    logits = torch.bmm(q, k.transpose(1, 2)) / shape[-1] ** 0.5
    _close(lse, torch.logsumexp(logits, -1))
    got = attention_bwd(q, k, v, o, lse, do)
    for g, w in zip(got, attention_bwd_reference(q, k, v, do)):
        _rel_close(g, w, rel=1e-5)
    assert (attention_fwd.launches, attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(o, attention_fwd(q, k, v)[0])
    for g, again in zip(got, attention_bwd(q, k, v, o, lse, do)):
        assert torch.equal(g, again)


def test_attention_function(dev):
    q, k, v, ct = (_randn(dev, 2, 50, 32, seed=i) for i in range(4))
    got = _grads(attention, (q, k, v), ct)
    want = _grads(attention_reference, (q, k, v), ct)
    for u, w in zip(got, want):
        _rel_close(u, w, rel=1e-5)


def test_attention_refuses_what_it_cannot_take(dev):
    for d in (6, 516):
        x = _randn(dev, 1, 8, d)
        with pytest.raises(ValueError, match="multiple of 4"):
            attention_fwd(x, x, x)
    x = _randn(dev, 1, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        attention_fwd(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2))


# ----------------------------------------------------------------- K4s --

_S2_SHAPES = [((2, 18, 30, 8), 12), ((1, 4, 4, 4), 4), ((3, 34, 10, 36), 68),
              ((1, 16, 16, 132), 8)]


@pytest.mark.parametrize("shape,cout", _S2_SHAPES)
def test_conv3s2_kernels(dev, shape, cout):
    """Ragged tiles on both GEMM sides, N at most 64 and above, the four
    parity classes of the dgrad; repeats are bit-equal."""
    cin = shape[-1]
    x = _randn(dev, *shape)
    w = _randn(dev, 3, 3, cin, cout, scale=0.1, seed=1)
    b = _randn(dev, cout, scale=0.1, seed=2)
    dy = _randn(dev, shape[0], shape[1] // 2, shape[2] // 2, cout, seed=3)
    before = (conv3s2.launches, conv3s2_dgrad.launches, conv3s2_wgrad.launches)
    y = conv3s2(x, w, b)
    dx = conv3s2_dgrad(dy, w)
    dw = conv3s2_wgrad(x, dy)
    assert (conv3s2.launches, conv3s2_dgrad.launches,
            conv3s2_wgrad.launches) == tuple(n + 1 for n in before)
    _rel_close(y, conv3s2_reference(x, w, b), rel=1e-5)
    _rel_close(conv3s2(x, w, None), conv3s2_reference(x, w, None), rel=1e-5)
    _rel_close(dx, conv3s2_dgrad_reference(dy, w), rel=1e-5)
    _rel_close(dw, conv3s2_wgrad_reference(x, dy), rel=1e-5)
    assert torch.equal(y, conv3s2(x, w, b))
    assert torch.equal(dw, conv3s2_wgrad(x, dy))
    assert torch.equal(dx, conv3s2_dgrad(dy, w))


def _fp64_err(out, exact):
    return ((out.double() - exact).abs().max() / exact.abs().max()).item()


def _conv_fp64(x, w, b, stride, pad):
    y = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        None if b is None else b.double(), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _functions_run(fn) -> set:
    """The CUDA functions one call of ``fn`` launched, by name:
    "void (anonymous namespace)::f<64>(...)" -> f (``_captured``)."""
    return {m.group(1) for e in _captured(fn)
            for m in [re.search(r"(\w+)[<(]", e.name)] if m}


@pytest.mark.parametrize("nb,h,cin,cout", [
    pytest.param(2, 256, 64, 128, id="d128"),
    pytest.param(2, 128, 128, 256, id="d256"),
    pytest.param(8, 256, 64, 128, id="d128-b8"),
    pytest.param(3, 34, 36, 68, id="ragged-c36-f68"),
    pytest.param(1, 16, 132, 8, id="ragged-c132-f8")])
def test_conv3s2_fp32_forward(dev, nb, h, cin, cout):
    """The fp32 forward (tf32x3) at the downsamples' widths (N of 128, the
    ring over 18 and 36 K stages) and at ragged ones (a 64-wide N tile,
    chunks of C that fill no 32-channel row, M tiles cut at the plane's
    end): within 1e-5 of the plain version, its error from float64 at most
    twice the plain version's, repeats bit-equal, and only the split's
    functions launched."""
    x = _randn(dev, nb, h, h + 2, cin)
    w = _randn(dev, 3, 3, cin, cout, scale=0.05, seed=1)
    b = _randn(dev, cout, scale=0.05, seed=2)
    y, ref = conv3s2(x, w, b), conv3s2_reference(x, w, b)
    _rel_close(y, ref, rel=1e-5)
    exact = _conv_fp64(x, w, b, 2, 1)
    assert _fp64_err(y, exact) <= 2.0 * _fp64_err(ref, exact)
    assert torch.equal(y, conv3s2(x, w, b))
    fns = _functions_run(lambda: conv3s2(x, w, b))
    assert {"conv_fwd_wsplit_kernel", "conv_fwd_tf32_kernel"} <= fns, fns
    assert "conv_fwd_kernel" not in fns, fns


@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv_core_fp32_forward(dev, k):
    """The VALID stride-1 forward (tf32x3) at 1 (one tap, K = one chunk of
    20 channels), 3 and 7 (49 taps): within 1e-5 of the plain version,
    repeats bit-equal. Its error from float64 is not held to twice the
    plain version's here: with 20 channels a tap cuDNN's fp32 sums read
    2.1e-7 of the largest value, below the split's own floor (the dropped
    lo x lo term and lo's rounding to TF32, ~2^-22 of a product; 5.0e-7 at
    k = 7 on an H100), while at the path's widths the split reads 0.3-0.5x
    the plain version's error (``test_conv3s2_fp32_forward``)."""
    xp = _randn(dev, 2, 19, 23, 20)
    wf = _randn(dev, k * k * 20, 36, scale=0.1, seed=1)
    y, ref = conv_core(xp, wf, k, k), conv_core_reference(xp, wf, k, k)
    _rel_close(y, ref, rel=1e-5)
    assert torch.equal(y, conv_core(xp, wf, k, k))


@pytest.mark.parametrize("nb,h,cin,cout", [(2, 256, 64, 128),
                                            (2, 128, 128, 256)],
                         ids=["d128", "d256"])
def test_conv3s2_fp32_grads_at_path_widths(dev, nb, h, cin, cout):
    """The fp32 dgrad and wgrad (tf32x3) at the downsamples' widths: one
    parity class per tap count, N = C of 64 (m64n64) and 128, the wgrad's
    chunks of 32-pixel stages; repeats are bit-equal."""
    x = _randn(dev, nb, h, h, cin)
    w = _randn(dev, 3, 3, cin, cout, scale=0.05, seed=1)
    dy = _randn(dev, nb, h // 2, h // 2, cout, seed=2)
    dx, dw = conv3s2_dgrad(dy, w), conv3s2_wgrad(x, dy)
    _rel_close(dx, conv3s2_dgrad_reference(dy, w), rel=1e-5)
    _rel_close(dw, conv3s2_wgrad_reference(x, dy), rel=1e-5)
    assert torch.equal(dx, conv3s2_dgrad(dy, w))
    assert torch.equal(dw, conv3s2_wgrad(x, dy))


@pytest.mark.parametrize("cin,cout", [(4, 132), (8, 68), (12, 36), (36, 12),
                                      (68, 8), (132, 4)])
def test_conv_core_fp32_grads_ragged(dev, cin, cout):
    """The fp32 dgrad and wgrad of the 5x5 VALID conv at channel counts
    that fill no 32-channel chunk or 64/128-wide tile: zero-filled chunks,
    the B planes' rows past C, the masked edges; repeats are bit-equal."""
    from uig_torch.kernels import conv_s2

    xp = _randn(dev, 2, 13, 11, cin)
    w = _randn(dev, 5, 5, cin, cout, scale=0.05, seed=1)
    dy = _randn(dev, 2, 9, 7, cout, seed=2)
    dx = conv_s2._dgrad("conv_core", dy, w, (13, 11), 1, 0)
    dw = conv_s2._wgrad("conv_core", xp, dy, 5, 1, 0)
    _rel_close(dx, conv_s2._dgrad_reference(dy, w, (13, 11), 1, 0), rel=1e-5)
    _rel_close(dw, conv_s2._wgrad_reference(xp, dy, 5, 1, 0), rel=1e-5)
    assert torch.equal(dx, conv_s2._dgrad("conv_core", dy, w, (13, 11), 1, 0))
    assert torch.equal(dw, conv_s2._wgrad("conv_core", xp, dy, 5, 1, 0))


def test_conv3s2_fp32_backward_launches_the_split_kernels(dev):
    """The fp32 backward of the downsample runs the tf32x3 functions and
    none of the FMA dgrad and wgrad that they replaced."""
    x = _randn(dev, 2, 16, 16, 8)
    w = _randn(dev, 3, 3, 8, 16, scale=0.1, seed=1)
    b = _randn(dev, 16, scale=0.1, seed=2)
    ct = _randn(dev, 2, 8, 8, 16, seed=3)
    fns = _functions_run(lambda: _grads(conv3s2_act, (x, w, b), ct))
    assert {"conv_wsplit_kernel", "conv_dgrad_tf32_kernel",
            "conv_wgrad_tf32_kernel", "conv_wgrad_reduce_kernel"} <= fns, fns
    assert not fns & {"conv_dgrad_kernel", "conv_wgrad_kernel"}, fns


def test_conv3s2_function(dev):
    x = _randn(dev, 2, 12, 20, 16)
    w = _randn(dev, 3, 3, 16, 8, scale=0.1, seed=1)
    b = _randn(dev, 8, scale=0.1, seed=2)
    ct = _randn(dev, 2, 6, 10, 8, seed=3)
    got = _grads(conv3s2_act, (x, w, b), ct)
    want = _grads(conv3s2_reference, (x, w, b), ct)
    for u, v in zip(got, want):
        _rel_close(u, v, rel=1e-5)


# The head at the step's batches (16 and 8, two strips of 128 columns, 256
# rows in 32-row groups) and ragged planes: W of 4 (one m16 tile), 20 and
# 45 (a ragged second tile), 300 (three strips), H not a multiple of the
# row group; Cin 32, 64 and 68 (the last k8 step ragged); Cout 1 to 4 (one
# to four n8 tiles), both pad modes. The fp32 forward adds Cin 6 (4-byte
# pieces); the bf16 weight gradient takes Cin % 4 == 0 only.
_HEAD_SHAPES = [
    pytest.param((16, 256, 256, 64), 3, "reflect", id="head-b16"),
    pytest.param((8, 256, 256, 64), 3, "reflect", id="head-b8"),
    pytest.param((8, 256, 256, 64), 3, "zeros", id="head-b8-zeros"),
    pytest.param((1, 4, 4, 32), 4, "reflect", id="4x4-c32"),
    pytest.param((2, 37, 20, 32), 1, "reflect", id="37x20-c32"),
    pytest.param((2, 37, 45, 68), 2, "zeros", id="37x45-c68"),
    pytest.param((1, 45, 300, 64), 4, "reflect", id="45x300-c64"),
    pytest.param((3, 13, 19, 68), 3, "zeros", id="13x19-c68")]


def _conv7_fp64(x, w, b, pad_mode):
    if pad_mode == "zeros":
        return _conv_fp64(x, w, b, 1, 3)
    return _conv_fp64(reflect_pad(x.double(), 3), w, b, 1, 0)


@pytest.mark.parametrize("shape,cout,pad_mode", _HEAD_SHAPES + [
    pytest.param((2, 11, 23, 6), 3, "reflect", id="11x23-c6")])
def test_conv7_fp32_forward(dev, shape, cout, pad_mode):
    """K4f in fp32 (tf32x3, mma.sync): within 1e-4 of the plain version,
    its error from float64 at most FP64_ERR_OVER_PLAIN (2) times the plain
    version's, repeats bit-equal, and only the split kernel launched."""
    cin = shape[-1]
    x = _randn(dev, *shape)
    w = _randn(dev, 7, 7, cin, cout, scale=0.05, seed=1)
    b = _randn(dev, cout, scale=0.1, seed=2)
    y, ref = conv7(x, w, b, pad_mode), conv7_reference(x, w, b, pad_mode)
    _close(y, ref)
    exact = _conv7_fp64(x, w, b, pad_mode)
    assert _fp64_err(y, exact) <= 2.0 * _fp64_err(ref, exact)
    assert torch.equal(y, conv7(x, w, b, pad_mode))
    fns = _functions_run(lambda: conv7(x, w, b, pad_mode))
    assert "conv7_tf32_kernel" in fns and "conv7_kernel" not in fns, fns


def test_conv7_fp32_refuses_what_it_cannot_take(dev):
    x = _randn(dev, 1, 8, 8, 120)
    with pytest.raises(ValueError, match="up to 112"):
        conv7(x, _randn(dev, 7, 7, 120, 3), None)


@pytest.mark.parametrize("k,dtype", [
    *(pytest.param(k, torch.float32, id=str(k)) for k in (2, 3, 5)),
    *(pytest.param(k, torch.bfloat16, id=f"{k}-bf16") for k in (2, 3, 5))])
def test_conv_core(dev, k, dtype):
    """The VALID stride-1 conv, its output and gradients against autograd
    of the plain version: within 1e-5 relative in fp32, 1 bf16 ulp in bf16
    (all three on wgmma)."""
    xp = _randn(dev, 2, 11, 13, 8).to(dtype)
    wf = _randn(dev, k * k * 8, 12, scale=0.1, seed=1).to(dtype)
    ct = _randn(dev, 2, 12 - k, 14 - k, 12, seed=2).to(dtype)
    before = conv_core.launches
    got = _grads(lambda a, b: conv_core(a, b, k, k), (xp, wf), ct)
    assert conv_core.launches == before + 3
    want = _grads(lambda a, b: conv_core_reference(a, b, k, k), (xp, wf), ct)
    for u, v in zip(got, want):
        if dtype == torch.float32:
            _rel_close(u, v, rel=1e-5)
        else:
            _ulps_close(u, v)


def test_generator_launches_per_apply(dev):
    """The routing of a small generator on the card: per apply 5 norms, 2
    conv3+IN per block, the head, and the two downsamples on K4s."""
    from uig_torch.models import ResNetGenerator

    for dt in (torch.float32, torch.bfloat16):
        gen = ResNetGenerator(base_features=8, n_res_blocks=2,
                              dtype=dt).to(dev)
        K.reset_launch_counts()
        with torch.no_grad():
            y = gen(_randn(dev, 2, 32, 32, 3))
        torch.cuda.synchronize()
        assert y.dtype == dt and y.shape == (2, 32, 32, 3)
        counts = {k: v for k, v in K.launch_counts().items() if v}
        assert counts == {"instance_norm": 5, "conv3_in_act": 4, "conv7": 1,
                          "conv3s2": 2}, counts


# ---------------------------------------------------------------- bf16 --

BF = torch.bfloat16


def _ulps_close(kernel_out, plain_out, ulps=1.0):
    torch.cuda.synchronize()
    assert kernel_out.dtype == plain_out.dtype == BF
    m = plain_out.float().abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)
    err = (kernel_out.float() - plain_out.float()).abs().max().item()
    assert err <= ulps * ulp, (err, ulp)


# D % 8 == 0 (a 16-byte copy holds 8 bf16 values); the fp32 cases' ragged
# N and D of 8 to 512, and the VQGAN grid at the reconstruct apply's batch
# 4 (two key ranges) and the step's union batch 8 (one)
_ATTN_BF16_SHAPES = [(1, 37, 64), (2, 300, 256), (1, 70, 512), (3, 33, 40),
                     (2, 45, 8), (2, 129, 128), (9, 1024, 64),
                     (4, 1024, 512), (8, 1024, 512)]


@pytest.mark.parametrize("shape", _ATTN_BF16_SHAPES, ids=str)
def test_attention_kernels_bf16(dev, shape):
    """bf16 K5f and K5b: o and dq/dk/dv within 1 bf16 ulp of the plain
    versions; bit-equal to the fp32 kernels on the widened inputs, rounded
    once (the forward's fp32 o and lse unrounded), since a bf16 operand is
    exact in TF32 and the bf16 design drops only products with exact
    zeros; those fp32 outputs within 1e-5 of the plain fp32 versions;
    repeats bit-equal; one launch each, counted under the fp32 names."""
    w = [_randn(dev, *shape, seed=i).to(BF).float() for i in range(4)]
    q, k, v, do = (t.to(BF) for t in w)
    before = (attention_fwd.launches, attention_bwd.launches)
    o, lse, o32 = attention_fwd(q, k, v)
    got = attention_bwd(q, k, v, o32, lse, do)
    assert (attention_fwd.launches, attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert o.dtype == BF and o32.dtype == lse.dtype == torch.float32
    _ulps_close(o, attention_reference(q, k, v))
    for g, r in zip(got, attention_bwd_reference(q, k, v, do)):
        _ulps_close(g, r)
    o_f, lse_f, _ = attention_fwd(*w[:3])
    assert torch.equal(o32, o_f) and torch.equal(lse, lse_f)
    assert torch.equal(o, o_f.to(BF))
    _rel_close(o_f, attention_reference(*w[:3]), rel=1e-5)
    for g, g_f, r in zip(got, attention_bwd(*w[:3], o_f, lse_f, w[3]),
                         attention_bwd_reference(*w)):
        assert torch.equal(g, g_f.to(BF))
        _rel_close(g_f, r, rel=1e-5)
    assert torch.equal(o, attention_fwd(q, k, v)[0])
    for g, again in zip(got, attention_bwd(q, k, v, o32, lse, do)):
        assert torch.equal(g, again)


def test_attention_function_bf16(dev):
    q, k, v, ct = (_randn(dev, 2, 50, 32, seed=i).to(BF) for i in range(4))
    got = _grads(attention, (q, k, v), ct)
    want = _grads(attention_reference, (q, k, v), ct)
    for u, w in zip(got, want):
        _ulps_close(u, w)


def test_attention_refuses_what_it_cannot_take_bf16(dev):
    """D = 4 in bf16 (no 16-byte copy of a row), mixed storage types and a
    bf16 residual raise on the card: no plain fallback."""
    x = _randn(dev, 1, 8, 4).to(BF)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention_fwd(x, x, x)
    x = _randn(dev, 1, 8, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        attention_fwd(x.to(BF), x, x.to(BF))
    q = x.to(BF)
    _, lse, o32 = attention_fwd(q, q, q)
    with pytest.raises(TypeError, match="o32"):
        attention_bwd(q, q, q, o32.to(BF), lse, q)


def test_augment_bf16(dev):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (3, 37, 41, 3),
                                      dtype=np.uint8)).to(dev)
    oy, ox = torch.tensor([0, 5, 2]), torch.tensor([9, 0, 4])
    flip = torch.tensor([True, False, True])
    y = augment_batch(x, oy, ox, flip, 32, BF)
    assert torch.equal(y, augment_batch_reference(x, oy, ox, flip, 32, BF))
    # the path shape, flipped and unflipped rows; (2, 9, 9, 1): scalar ends
    for shape, crop in (((8, 286, 286, 3), 256), ((2, 9, 9, 1), 9)):
        x, oy, ox, flip = _augment_case(dev, shape, crop, seed=1)
        y = augment_batch(x, oy, ox, flip, crop, BF)
        assert torch.equal(y, augment_batch_reference(x, oy, ox, flip, crop,
                                                      BF))


@pytest.mark.parametrize("shape", [(3, 13, 17, 36), (2, 64, 64, 64)])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_bf16(dev, shape, relu):
    c = shape[-1]
    x = _randn(dev, *shape, scale=2.0, shift=0.5).to(BF)
    g = _randn(dev, c, scale=0.2, shift=1.0, seed=1)
    b = _randn(dev, c, scale=0.2, seed=2)
    dy = _randn(dev, *shape, seed=3).to(BF)
    y, stats = _instance_norm_fwd(x, g, b, 1e-5, relu)
    _ulps_close(y, instance_norm_reference(x, g, b, relu=relu))
    dx, dg, db = instance_norm_bwd(x, g, b, dy, stats, relu=relu)
    rdx, rdg, rdb = instance_norm_bwd_reference(x, g, b, dy, stats,
                                                relu=relu)
    keep = torch.ones_like(x, dtype=torch.bool)
    if relu:
        xn = instance_norm_reference(x.float(), torch.ones_like(g),
                                     torch.zeros_like(b))
        keep = (xn * g + b).abs() >= 1e-4
    _ulps_close(torch.where(keep, dx, 0.0), torch.where(keep, rdx, 0.0))
    assert dg.dtype == db.dtype == torch.float32
    _rel_close(dg, rdg)
    _rel_close(db, rdb)
    again = instance_norm_bwd(x, g, b, dy, stats, relu=relu)
    assert all(torch.equal(u, v) for u, v in zip((dx, dg, db), again))


# In bf16 the conv runs on the tensor cores (wgmma): C = 20 takes 8-byte A
# pieces and F = 12 and 132 B by cp.async; the path shape at batch 2,
# (2, 64, 64, 256) -> 256, takes 16-byte pieces and B by TMA, and its
# 36-stage K (9 taps x 4 chunks) wraps the 3-stage ring; C = 8 is one
# ragged chunk. Repeats are bit-equal (the moments' order is fixed).
@pytest.mark.parametrize("shape,f,pad_mode,relu", [
    pytest.param((2, 11, 13, 20), 12, "reflect", True, id="reflect"),
    pytest.param((2, 11, 13, 20), 12, "zeros", True, id="zeros"),
    pytest.param((2, 64, 64, 256), 256, "reflect", True, id="path-reflect"),
    pytest.param((2, 64, 64, 256), 256, "zeros", False, id="path-zeros"),
    pytest.param((1, 16, 16, 8), 132, "reflect", False, id="c8-f132")])
def test_conv3_in_act_bf16(dev, shape, f, pad_mode, relu):
    c = shape[-1]
    x = _randn(dev, *shape).to(BF)
    w = _randn(dev, 3, 3, c, f, scale=0.1, seed=1).to(BF)
    b, g, be = (_randn(dev, f, scale=0.1, seed=2),
                _randn(dev, f, scale=0.2, shift=1.0, seed=3),
                _randn(dev, f, scale=0.2, seed=4))
    before = conv3_in_act.launches
    y = conv3_in_act(x, w, b, g, be, relu=relu, pad_mode=pad_mode)
    assert conv3_in_act.launches == before + 1
    _ulps_close(y, conv3_in_act_reference(x, w, b, g, be, relu=relu,
                                          pad_mode=pad_mode), ulps=2)
    assert torch.equal(y, conv3_in_act(x, w, b, g, be, relu=relu,
                                       pad_mode=pad_mode))


# In bf16 the dgrad runs on the tensor cores (wgmma) in 4 x 16 patches: the
# path shape at batch 2 (256^2, 64 -> 3); ragged planes whose ring rows and
# columns (1-3 and n-4..n-2) fall in partial patches, (1, 9, 33, 16) and
# (2, 37, 45, 24); a 4 x 4 plane where both rings of a row overlap (every
# pixel has up to 3 sources a side); Cin = 68 (two 64-wide slices, the
# second ragged) with Cout = 2. Repeats are bit-equal.
@pytest.mark.parametrize("shape,cout,pad_mode", [
    pytest.param((2, 37, 45, 24), 3, "reflect", id="reflect"),
    pytest.param((2, 37, 45, 24), 3, "zeros", id="zeros"),
    pytest.param((2, 256, 256, 64), 3, "reflect", id="path-reflect"),
    pytest.param((2, 256, 256, 64), 3, "zeros", id="path-zeros"),
    pytest.param((1, 9, 33, 16), 4, "reflect", id="9x33-reflect"),
    pytest.param((1, 9, 33, 16), 4, "zeros", id="9x33-zeros"),
    pytest.param((1, 4, 4, 8), 1, "reflect", id="4x4-reflect"),
    pytest.param((2, 11, 19, 68), 2, "reflect", id="c68-reflect")])
def test_conv7_bf16(dev, shape, cout, pad_mode):
    nb, h, wd, cin = shape
    x = _randn(dev, *shape).to(BF)
    w = _randn(dev, 7, 7, cin, cout, scale=0.05, seed=1).to(BF)
    b = _randn(dev, cout, scale=0.1, seed=2).to(BF)
    dy = _randn(dev, nb, h, wd, cout, seed=3).to(BF)
    _ulps_close(conv7(x, w, b, pad_mode), conv7_reference(x, w, b, pad_mode))
    before = conv7_dgrad.launches
    dx = conv7_dgrad(dy, w, pad_mode)
    assert conv7_dgrad.launches == before + 1
    _ulps_close(dx, conv7_dgrad_reference(dy, w, pad_mode))
    assert torch.equal(dx, conv7_dgrad(dy, w, pad_mode))
    _ulps_close(conv7_wgrad(x, dy, pad_mode),
                conv7_wgrad_reference(x, dy, pad_mode))


# In bf16 all three run on the tensor cores (wgmma): the ragged shapes
# (forward and wgrad: C % 8 == 4 takes 8-byte A pieces, F = 4, 12 and 68 B
# by cp.async; dgrad, whose A reads F channels and whose B rows are C
# wide: F % 8 == 4 takes 8-byte pieces, C = 4, 36 and 132 B by cp.async,
# C <= 64 the 64-wide ring) and both path shapes at batch 2, d128 (dgrad
# on the 64-wide ring) and d256, where the 128-pixel M tiles cross image
# boundaries and the 3-stage ring wraps over all 9 and 18 K chunks (the
# dgrad's classes: 2 to 8 and 4 to 16).
@pytest.mark.parametrize("shape,cout", _S2_SHAPES + [
    ((2, 256, 256, 64), 128), ((2, 128, 128, 128), 256)])
def test_conv3s2_bf16(dev, shape, cout):
    cin = shape[-1]
    x = _randn(dev, *shape).to(BF)
    w = _randn(dev, 3, 3, cin, cout, scale=0.1, seed=1).to(BF)
    b = _randn(dev, cout, scale=0.1, seed=2).to(BF)
    dy = _randn(dev, shape[0], shape[1] // 2, shape[2] // 2, cout,
                seed=3).to(BF)
    before = (conv3s2.launches, conv3s2_dgrad.launches, conv3s2_wgrad.launches)
    y = conv3s2(x, w, b)
    dx = conv3s2_dgrad(dy, w)
    dw = conv3s2_wgrad(x, dy)
    assert (conv3s2.launches, conv3s2_dgrad.launches,
            conv3s2_wgrad.launches) == tuple(n + 1 for n in before)
    _ulps_close(y, conv3s2_reference(x, w, b))
    _ulps_close(conv3s2(x, w, None), conv3s2_reference(x, w, None))
    _ulps_close(dx, conv3s2_dgrad_reference(dy, w))
    _ulps_close(dw, conv3s2_wgrad_reference(x, dy))
    assert torch.equal(y, conv3s2(x, w, b))
    assert torch.equal(dx, conv3s2_dgrad(dy, w))
    assert torch.equal(dw, conv3s2_wgrad(x, dy))


# The head at the step's batches (16 and 8, two strips of 128 columns, 256
# rows of 32-row groups) and ragged planes: W of 4 (one m16 tile, 4
# columns), 20 (a ragged second tile), 300 (three strips), H not a multiple
# of the row group; Cin 68 (8-byte pieces, five k16 steps, the last ragged)
# and 8; Cout 1 to 4 (one to four n8 tiles).
@pytest.mark.parametrize("shape,cout,pad_mode", [
    pytest.param((16, 256, 256, 64), 3, "reflect", id="head-b16"),
    pytest.param((8, 256, 256, 64), 3, "reflect", id="head-b8"),
    pytest.param((8, 256, 256, 64), 3, "zeros", id="head-b8-zeros"),
    pytest.param((1, 4, 4, 8), 1, "reflect", id="4x4-c1"),
    pytest.param((2, 37, 20, 68), 2, "zeros", id="37x20-c68"),
    pytest.param((1, 45, 300, 16), 4, "reflect", id="45x300-c4"),
    pytest.param((3, 13, 19, 24), 3, "zeros", id="13x19-zeros")])
def test_conv7_bf16_forward(dev, shape, cout, pad_mode):
    """K4f in bf16 on mma.sync: within 1 bf16 ulp of the plain version,
    repeats bit-equal, and only the tensor-core kernel launched."""
    cin = shape[-1]
    x = _randn(dev, *shape).to(BF)
    w = _randn(dev, 7, 7, cin, cout, scale=0.05, seed=1).to(BF)
    b = _randn(dev, cout, scale=0.1, seed=2).to(BF)
    y = conv7(x, w, b, pad_mode)
    _ulps_close(y, conv7_reference(x, w, b, pad_mode))
    assert torch.equal(y, conv7(x, w, b, pad_mode))
    fns = _functions_run(lambda: conv7(x, w, b, pad_mode))
    assert "conv7_mma_kernel" in fns and "conv7_kernel" not in fns, fns


def test_conv7_bf16_refuses_what_it_cannot_take(dev):
    x = _randn(dev, 1, 8, 8, 6).to(BF)
    with pytest.raises(ValueError, match="multiple of 4"):
        conv7(x, _randn(dev, 7, 7, 6, 3).to(BF), None)
    x = _randn(dev, 1, 8, 8, 260).to(BF)
    with pytest.raises(ValueError, match="up to 256"):
        conv7(x, _randn(dev, 7, 7, 260, 3).to(BF), None)


@pytest.mark.parametrize("shape,cout,pad_mode", _HEAD_SHAPES)
def test_conv7_bf16_wgrad(dev, shape, cout, pad_mode):
    """K4w in bf16 on wgmma: within 1 bf16 ulp of the plain version,
    repeats bit-equal, and only the tensor-core kernel and its sum
    launched."""
    x = _randn(dev, *shape).to(BF)
    dy = _randn(dev, *shape[:3], cout, seed=3).to(BF)
    before = conv7_wgrad.launches
    dw = conv7_wgrad(x, dy, pad_mode)
    assert conv7_wgrad.launches == before + 1
    _ulps_close(dw, conv7_wgrad_reference(x, dy, pad_mode))
    assert torch.equal(dw, conv7_wgrad(x, dy, pad_mode))
    fns = _functions_run(lambda: conv7_wgrad(x, dy, pad_mode))
    assert {"conv7_wgrad_wgmma_kernel", "conv7_wgrad_sum_kernel"} <= fns, fns
    assert not fns & {"conv7_wgrad_kernel", "conv7_wgrad_reduce_kernel"}, fns


def test_conv7_bf16_wgrad_refuses_what_it_cannot_take(dev):
    for cin, match in ((6, "multiple of 4"), (260, "up to 256")):
        x = _randn(dev, 1, 8, 8, cin).to(BF)
        with pytest.raises(ValueError, match=match):
            conv7_wgrad(x, _randn(dev, 1, 8, 8, 3).to(BF))


def test_bf16_operands_are_checked(dev):
    x = _randn(dev, 1, 8, 8, 8)
    w = _randn(dev, 3, 3, 8, 8)
    with pytest.raises(TypeError, match="w must be bfloat16"):
        conv3s2(x.to(BF), w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv3s2(x.half(), w.half())
    g = torch.ones(8, device=dev)
    with pytest.raises(TypeError, match="gamma must be float32"):
        instance_norm(x.to(BF), g.to(BF), g.to(BF))


# ---------------------------------------------------------------------------
# the input pipeline and fit on the card
# ---------------------------------------------------------------------------


def test_pipeline_pinned_copy_under_a_concurrent_step(dev):
    """The pipeline's batches on the card hold the host batches' bytes
    while the consumer's stream runs a long step before it reads them and
    allocates and frees as it goes (so the allocator recycles memory a
    later copy could land in), with three producer threads copying."""
    from uig_torch.data import UnpairedPipeline
    from uig_torch.data.datasets import SyntheticUnpairedDataset

    syn = SyntheticUnpairedDataset(7, 64, 1)
    host = UnpairedPipeline(syn.domain_a, syn.domain_b, 4, device="cpu",
                            num_workers=2)
    pipe = UnpairedPipeline(syn.domain_a, syn.domain_b, 4, device=dev,
                            num_workers=2, prefetch=2,
                            producer_threads=3).start()
    w = torch.randn(2048, 2048, device=dev) / 64
    try:
        for _ in range(10):
            a, b = next(pipe)
            assert a.device == dev and a.dtype == torch.uint8
            y = w
            for _ in range(12):  # the step's work, queued before the read
                y = torch.tanh(y @ w)
            got = (a.clone(), b.clone(), y.sum())
            del a, b, y
            want = next(host)
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])
    finally:
        pipe.stop()
    assert pipe.state_dict() == host.state_dict() == {"t_consumed": 10}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_resume_is_byte_identical(dev, tmp_path, dtype):
    """fit on the card at a small width: 2 steps, a restore and 2 more end
    byte-identical to 4 unbroken steps (every tensor and the cursor)."""
    from uig_torch.checkpoint import CheckpointManager
    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.train.loop import fit

    over = ["model.image_size=32", "data.load_size=36", "model.n_res_blocks=1",
            "model.g_base_features=16", "model.d_base_features=16",
            "model.d_layers=2", "data.batch_size=2", "data.synthetic_len=12",
            "data.num_workers=1", "opt.pool_size=4", "run.log_every=2",
            "run.ckpt_every=2", "eval.sample_grid_every=0",
            f"model.compute_dtype={dtype}", f"run.workdir={tmp_path}"]
    cfg = apply_overrides(get_preset("smoke64"), over)
    fit(apply_overrides(cfg, ["run.name=a"]), max_steps=4, device="cuda")
    fit(apply_overrides(cfg, ["run.name=b"]), max_steps=2, device="cuda")
    fit(apply_overrides(cfg, ["run.name=b"]), max_steps=4, device="cuda")
    ta, ma = CheckpointManager(str(tmp_path / "a" / "ckpt")).read()
    tb, mb = CheckpointManager(str(tmp_path / "b" / "ckpt")).read()
    assert ma["ints"] == mb["ints"] and ma["ints"]["step"] == 4
    assert ma["data_state"] == mb["data_state"] == {"t_consumed": 4}
    assert set(ta) == set(tb)
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not differ, differ[:5]
    assert ta["pool_a/buffer"].dtype == getattr(torch, dtype)


# ---------------------------------------------------------------------------
# evaluation on the card: bf16 serving, the extractors, eval-fid
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """A small CycleGAN run trained on the card with the in-training FID
    (every 2 steps, 6 samples): 4 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.train.loop import fit

    tmp = tmp_path_factory.mktemp("eval_run")
    over = ["model.image_size=32", "data.load_size=36", "model.n_res_blocks=1",
            "model.g_base_features=16", "model.d_base_features=16",
            "model.d_layers=2", "data.batch_size=2", "data.synthetic_len=12",
            "data.num_workers=1", "opt.pool_size=4", "run.log_every=2",
            "run.ckpt_every=2", "eval.sample_grid_every=0",
            "eval.fid_every=2", "eval.fid_num_samples=6",
            "eval.fid_batch_size=4", f"run.workdir={tmp}", "run.name=r"]
    fit(apply_overrides(get_preset("smoke64"), over), max_steps=4,
        device="cuda")
    return str(tmp / "r")


def test_bf16_translator_repeats_byte_identical(dev, eval_run):
    """The run's EMA served in bf16 (K2f, K3, K4f and K4s in bf16, one
    apply's launches): two calls on one batch give the same bytes, and the
    output is not the fp32 one's."""
    from uig_torch.serving import Translator

    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (3, 36, 36, 3), dtype=np.uint8)
    tr16 = Translator.from_run_dir(eval_run, batch_size=4, device="cuda",
                                   overrides=["model.eval_dtype=bfloat16"])
    assert tr16.generator.dtype == BF and tr16.meta["eval_dtype"] == "bfloat16"
    K.reset_launch_counts()
    a = tr16(raw)
    counts = K.launch_counts()
    assert counts["conv3_in_act"] == 2 and counts["instance_norm"] == 5
    b = tr16(raw)
    assert a.shape == (3, 32, 32, 3) and np.array_equal(a, b)
    x = torch.from_numpy(raw).to(dev)
    from uig_torch.kernels import center_crop_normalize

    y16 = tr16.translate_float(center_crop_normalize(x, 32))
    assert y16.dtype == BF
    tr32 = Translator.from_run_dir(eval_run, batch_size=4, device="cuda")
    y32 = tr32.translate_float(center_crop_normalize(x, 32))
    gap = (y16.float() - y32).abs().max().item()
    assert 0 < gap < 0.1, gap


@pytest.mark.parametrize("kind,size", [("random", 64), ("inception", 64),
                                       ("inception", 75)])
def test_feature_extractors_on_the_card(dev, kind, size):
    """The seed-0 extractors on the card against their CPU runs (library
    convs, fp32 without TF32, another order of sums): within 1e-4 of the
    largest feature; 64² inputs to InceptionV3 go through the resize to
    299²; two card runs are bit-equal."""
    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.eval.fid import make_feature_fn

    cfg = apply_overrides(get_preset("smoke64"),
                          [f"eval.fid_features={kind}"])
    x = torch.from_numpy(np.random.default_rng(size).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32))
    card, name = make_feature_fn(cfg, "cuda")
    cpu, _ = make_feature_fn(cfg, "cpu")
    got, again = card(x.to(dev)), card(x.to(dev))
    want = cpu(x)
    assert torch.equal(got, again)
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), (name, err)


def test_eval_fid_repeats_bit_equal(dev, eval_run, capsys):
    """eval-fid on the card twice (random features; FID, then KID) gives
    the same numbers; the in-training FID lines were written."""
    import json

    from uig_torch.cli.__main__ import main

    with open(os.path.join(eval_run, "metrics.jsonl")) as f:
        fids = [json.loads(x) for x in f if '"fid"' in x]
    assert [r["step"] for r in fids] == [2, 4]
    outs = []
    for extra in ([], [], ["--kid"], ["--kid"]):
        assert main(["eval-fid", "--run-dir", eval_run, "--num-samples",
                     "6", "--batch-size", "4", *extra]) == 0
        outs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert outs[0] == outs[1] and outs[2] == outs[3]
    assert np.isfinite(outs[0]["fid"]) and outs[0]["fid"] > 0


# ------------------------------------------------------- contrastive (CUT) --

@pytest.mark.parametrize("dt,shape", [
    (torch.float32, (2, 33, 35, 64)), (BF, (2, 33, 35, 64)),
    (BF, (16, 128, 128, 128))], ids=["fp32", "bf16", "bf16-path"])
def test_instance_norm_at_a_feature_tap(dev, dt, shape):
    """A CUT tap on a norm before its ReLU (d128's, layer 4): K2f runs with
    relu=False and the ReLU after it, and K2b takes the sum of the NCE
    gradient at the norm's output and the ReLU-masked one; against the
    plain versions of both on the card. bf16 within 1 bf16 ulp (dx) and
    dgamma/dbeta (fp32) within 1e-4 relative; fp32 within 1e-4."""
    c = shape[-1]
    x = _randn_dev(dev, *shape, scale=2.0, shift=0.5).to(dt)
    g = _randn_dev(dev, c, scale=0.2, shift=1.0, seed=1)
    b = _randn_dev(dev, c, scale=0.2, seed=2)
    ct_tap = _randn_dev(dev, *shape, seed=3).to(dt)
    ct_relu = _randn_dev(dev, *shape, seed=4).to(dt)

    def tap(fn):
        ins = [t.detach().clone().requires_grad_(True) for t in (x, g, b)]
        y = fn(*ins)
        loss = ((y * ct_tap).float().sum()
                + (torch.relu(y) * ct_relu).float().sum())
        return [y] + list(torch.autograd.grad(loss, ins))

    before = (instance_norm.launches, instance_norm_bwd.launches)
    got = tap(lambda *a: instance_norm_act(*a, relu=False))
    assert (instance_norm.launches, instance_norm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = tap(lambda *a: instance_norm_reference(*a, relu=False))
    for i, (u, v) in enumerate(zip(got, want)):
        if dt == BF and i < 2:
            _ulps_close(u, v)
        else:
            _rel_close(u.float(), v.float())
    again = tap(lambda *a: instance_norm_act(*a, relu=False))
    assert all(torch.equal(u, v) for u, v in zip(got, again))


def test_instance_norm_plans_at_the_contrastive_batches(dev):
    """K2f's cooperative plan at CUT's batch 16 and the fused CUT apply's
    32, for each of the generator's norm shapes, runs against the plain
    version (bf16, ReLU off as at a tap and on)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in ((32, 256, 256, 64), (16, 64, 64, 256), (32, 64, 64, 256)):
        b, h, w, c = shape
        plan = norm.fwd_plan(b, h * w, c, 2, sms)
        assert plan.chunks >= 1
        for relu in (False, True):
            _in_fwd_case(dev, shape, BF, relu)


def _contrastive_counts(kind: str, n_blocks: int, identity: bool) -> dict:
    """Kernel launches of one step of the contrastive trainers with taps
    (0, 4, 8, 10) on a generator of ``n_blocks`` (>= 2) blocks, unfused:
    a full apply launches 5 norms, 2 conv3+IN a block, 2 downsamples and
    the head; an encoder pass to layer 10 the 3 encoder norms, 4 conv3+IN
    and both downsamples; a discriminator apply 2 norms (d_layers 2). Each
    norm, conv3+IN, downsample and head is differentiated, and each
    conv3+IN backward runs the norm backward once."""
    if kind == "dclgan":  # 2 translations, 2 identities, 2 query passes
        full, enc = 4, 2
    else:  # the translation and its query pass, and the identity's
        full = enc = 2 if identity else 1
    d_applies = {"fastcut": 3, "cut": 3, "dclgan": 6}[kind]
    k2f = 5 * full + 3 * enc + 2 * d_applies
    k3 = 2 * n_blocks * full + 4 * enc
    s2 = 2 * (full + enc)
    return {"augment_batch": 2, "instance_norm": k2f,
            "instance_norm_bwd": k2f + k3, "conv3_in_act": k3,
            "conv7": full, "conv7_dgrad": full, "conv7_wgrad": full,
            "conv3s2": s2, "conv3s2_dgrad": s2, "conv3s2_wgrad": s2}


@pytest.mark.parametrize("preset,kind", [
    ("fastcut256", "fastcut"), ("cut256_multihost", "cut"),
    ("dclgan256", "dclgan")])
def test_contrastive_step_launches(dev, preset, kind):
    """One CUT, FastCUT or DCLGAN step (bf16, 32², two blocks) launches each
    kernel of the path the counted times, and two runs from one state are
    byte-identical."""
    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.train.loop import build_trainer

    cfg = apply_overrides(get_preset(preset), [
        "model.image_size=32", "data.load_size=36", "data.batch_size=2",
        "model.g_base_features=8", "model.n_res_blocks=2",
        "model.d_base_features=8", "model.d_layers=2",
        "model.nce_layers=(0,4,8,10)", "model.nce_patches=16",
        "model.nce_proj_dim=16", "parallel.multihost=false"])
    tr = build_trainer(cfg, "cuda")
    rng = np.random.default_rng(0)
    batch = tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                  for _ in range(2))
    s0 = tr.init_state(0)
    torch.use_deterministic_algorithms(True)
    try:
        K.reset_launch_counts()
        s1, m = tr.train_step(s0.clone(), batch)
        torch.cuda.synchronize()
        counts = {k: v for k, v in K.launch_counts().items() if v}
        s2, _ = tr.train_step(s0.clone(), batch)
    finally:
        torch.use_deterministic_algorithms(False)
    assert counts == _contrastive_counts(
        kind, 2, cfg.loss.nce_include_identity), counts
    assert all(np.isfinite(float(v)) for v in m.values())
    from uig_torch.convert import jax_flat_from_train_state

    f1, f2 = jax_flat_from_train_state(s1), jax_flat_from_train_state(s2)
    assert all(np.array_equal(f1[k], f2[k]) for k in f1)


def test_antialias_step_is_deterministic_on_the_card(dev):
    """model.resample=antialias (BlurPool, BlurUpsample: depthwise cuDNN
    convs and the pads' slices) trains on the card under deterministic
    algorithms, as ``fit`` runs it: two steps from one state are
    byte-identical, in bf16 and fp32, and the generator's output is
    within 1e-4 (fp32) of the CPU's."""
    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.convert import jax_flat_from_train_state
    from uig_torch.train import CycleGANTrainer

    for dtype in ("bfloat16", "float32"):
        cfg = apply_overrides(get_preset("cyclegan256_dp"), [
            "model.image_size=32", "data.load_size=36", "data.batch_size=2",
            "model.g_base_features=8", "model.n_res_blocks=1",
            "model.d_base_features=8", "model.d_layers=2",
            "loss.lambda_lpips=0", f"model.compute_dtype={dtype}",
            "model.resample=antialias"])
        tr = CycleGANTrainer(cfg, "cuda")
        rng = np.random.default_rng(1)
        batch = tuple(rng.integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
                      for _ in range(2))
        s0 = tr.init_state(0)
        torch.use_deterministic_algorithms(True)
        try:
            s1, m = tr.train_step(s0.clone(), batch)
            s2, _ = tr.train_step(s0.clone(), batch)
        finally:
            torch.use_deterministic_algorithms(False)
        assert all(np.isfinite(float(v)) for v in m.values())
        f1, f2 = jax_flat_from_train_state(s1), jax_flat_from_train_state(s2)
        assert all(np.array_equal(f1[k], f2[k]) for k in f1)
    x = _randn(dev, 2, 32, 32, 3).clamp(-1, 1)
    cpu = CycleGANTrainer(cfg, "cpu")
    want = cpu.translate(s1.to("cpu").ema, x.cpu(), "a2b")
    got = tr.translate(s1.ema, x, "a2b").cpu()
    assert (got - want).abs().max().item() <= ATOL
