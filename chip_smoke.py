#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's training step and serving path on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. env: the card's name and power limit (nvidia-smi), torch/CUDA versions,
   and the time to build the CUDA kernels from ``src/uig_torch/csrc``.
2. kernels: each CUDA kernel at the shapes the training step and the
   generator give it (the norm cases' inputs drawn on the card), held
   against its plain PyTorch version on the card
   (fp32, TF32 off) within a stated tolerance, and timed with CUDA events
   beside the plain version, one PyTorch library call computing the same
   function (a yardstick the port never calls), and the least time the card
   could take (bound). Also the library convs of the fused conv3+IN
   backward, timed with their bound.
   Every kernel runs twice: in fp32 and in bf16 (tolerances in bf16 ulps
   of the output's largest magnitude, ``TOL_BF16``; the bf16 attention
   kernels are also held bit-equal to the fp32 kernels on the widened
   inputs, rounded once, and those within the fp32 gate of the plain
   version, ``_attention_bf16_check``). The cases
   of design "tf32x3" (fp32 on the tensor cores in the three-term TF32
   split: the attention kernels, the fused conv3+IN, K4s's forward,
   input and weight gradients and the 7x7 head's forward) also report the
   kernel's and the plain version's error against float64 on the card,
   the kernel's at most ``FP64_ERR_OVER_PLAIN`` times the plain version's,
   and the CUDA kernels the yardstick launched. The norm backward's cases
   take the statistics their forward kept. Each case also reports the
   kernel's own device time in one call from the profiler (``device_ms``),
   beside ``ms``, which times back-to-back calls and so, for the small
   kernels, the host's rate of issuing them, and the host's time to issue
   one call (``host_ms``, a host clock around calls in a row).
3. train: a ``CycleGANTrainer`` for ``cyclegan256_dp`` at full width with
   ``model.compute_dtype=float32`` and ``loss.lambda_lpips=0``, from a
   seeded state, on seeded uint8 (8, 286, 286, 3) batches, under
   ``torch.use_deterministic_algorithms(True)``. One step's kernel
   launches; 3 steps twice from one state must give byte-identical state;
   one step at batch 1 on the card and on the CPU (plain versions) must
   agree, beside two control runs that say where a gap comes from
   (``compare_card_cpu`` states the tolerances); ``FP32_TRAIN_STEPS``
   steps on a fixed batch keep finite losses and a falling cycle loss; step time (median of
   CUDA-event timings), img/s, peak memory, and the top device kernels and
   idle share of one profiled step.
3b. train_bf16: the same for the preset as published, with no override:
   bf16 compute and the LPIPS term on (a seed-0 VGG in fp32, TF32 off);
   its batch-1 check takes the step four ways (``compare_card_cpu_bf16``,
   LPIPS's VGG on the CPU too for the CPU run): the kernels must add less
   than bf16 itself does, and the CPU must sit within twice that; 20
   steps. Before its result line, the same step with LPIPS off (timed, for
   continuity with earlier runs) and the LPIPS term alone (two distances at
   the step's batch and their input gradients), profiled.
3c. cut: the contrastive trainers as published, bf16 at 256² and batch
   16 with the pallas augment (``CUT_CASES``): ``fastcut256``, the CUT
   recipe of ``cut256_multihost`` in one process
   (``parallel.multihost=false``) and ``dclgan256``. For each, one step's
   launches of every kernel (``contrastive_per_step``: the translation's
   full apply, the query's encoder pass that stops at tap 16, D), 3 steps
   twice byte-identical, the step's gradients at batch 16 with the kernels
   against the plain versions, with bf16's own gap from fp32 as the
   yardstick (``compare_kernels_plain``), the batch-1 step four ways
   (``compare_card_cpu_bf16``), CUT_STEPS steps finite and timed, peak
   memory, and one profiled step with its designs. Then, on a checkpoint of
   the CUT run in a run directory written as ``fit`` writes it,
   ``translate --run-dir`` (PNGs equal to the EMA's translate; b2a refused
   with JAX's ValueError) and ``eval-fid`` (random-conv features, twice
   bit-equal). Last, the norm forward's counters must be back at 0.
4. slice: a ``Translator`` for ``cyclegan256_dp`` at full width, weights in
   the flax layout made from a seed with numpy and carried through
   ``uig_torch.convert``. A seeded uint8 batch (8, 286, 286, 3) goes through
   twice and must come out byte-identical; two images through the same model
   on the CPU (plain versions) must agree within 1 uint8 step; each apply
   must launch instance norm 5 times, conv3+IN 18 times, conv7 once and
   the stride-2 conv twice, and a profiled apply must run each in the
   design ``SLICE_DESIGNS`` names (K3, both downsamples and the head in
   "tf32x3") and give the first apply's bytes. A profiled call whose
   capture holds fewer launches of a kernel than its wrapper counted is
   taken again and listed under ``lost_records`` (``profile_call``).
5. serve: the HTTP server on the card answers 12 concurrent PNG requests,
   each equal to a direct ``Translator`` call, and reports its /stats.

6. vqgan_slice: a ``Translator`` for ``vqgan512`` (512² reconstruction
   through the codebook, fp32) at batch 4, weights from
   ``convert.seeded_flax`` (flax's initializers) through an ``.npz``.
   Each apply must launch the attention forward 4 times; two runs must be
   byte-identical; at batch 1 the card and the CPU (plain versions) must
   agree on the encoder output, on the codes wherever the two nearest
   codewords are further apart than rounding can reach, and on
   ``decode_codes`` of the same codes (``VQ_TOL``).
7. vqgan_train: a ``VQGANTrainer`` for ``vqgan512`` at full width with the
   fp32 overrides and ``loss.vq_disc_start=0`` (D and the adaptive weight
   on), batch 4 per domain (union 8). One step's launches; 3 steps twice
   byte-identical; the batch-1 card-vs-CPU step of phase 3's method;
   ``VQ_TRAIN_STEPS`` steps on a fixed batch with finite metrics and a
   falling ``rec``; step
   time, img/s, peak memory and one profiled step.
7b. vqgan_train_bf16: the same for ``vqgan512`` as published, bf16 compute,
   with only ``loss.vq_disc_start=0``; its batch-1 check takes the step
   four ways as 3b's does (``compare_card_cpu_bf16``);
   ``VQ_BF16_TRAIN_STEPS`` steps.
8. fit, last (its training processes share the card with this one):
   ``python -m uig_torch.cli train --preset cyclegan256_dp`` as
   published (bf16, LPIPS on) in training processes of its own, with only
   the data and the cadences set (``FIT_OVERRIDES``): run A goes 6 steps
   (its kernel launches counted around the command line's ``main``: 6
   steps and one sample grid's two translate applies); run B goes 3, the
   process exits, and a second process resumes it to 6; every tensor of
   the two final checkpoints must be byte-identical and the counts and
   cursors equal. The checkpoint restored onto the card and saved again
   (ms, bytes); ``translate --run-dir`` on run A must give the PNGs of a
   direct ``Translator`` call on the restored EMA; a run sent SIGTERM
   after its first metrics line must exit 0 with a checkpoint at the step
   it reached. Reports fit's step ms between log lines that no checkpoint
   or grid falls between, its ``images_per_sec_chip`` and
   ``input_stall_pct``, beside 3b's bare step. The training processes get
   no ``CUBLAS_WORKSPACE_CONFIG``: ``fit`` sets it. The runs take the
   in-training FID every 3 steps (random-conv features, 16 images, one
   translate apply each): both runs must write the same FIDs, the resumed
   one's included, keep the checkpoints of the best-FID retention, and
   leave the intervals with a FID out of the step time.
9. eval, on phase fit's run A (``phase_eval``): its EMA translated in bf16
   beside fp32 at batch 8 (one bf16 apply's launches, byte-identical
   repeats, generator ms and img/s of both, card against CPU in bf16 at
   batch 1 with bf16's own distance from fp32 as the yardstick,
   ``BF16_OVER_FLOOR``); ``run_eval_fid`` in-process on 64 eval images a
   side with the random-conv and the untrained InceptionV3 extractors (FID
   twice, bit for bit; KID and PRDC with the random-conv one; the first
   call's launches counted); each
   extractor on the card against the CPU at batch 2 (``EVAL_FEATURE_TOL``)
   and the img/s of translate and of each extractor; ``fid-stats`` of the
   B eval images, then ``--ref-stats``, equal to the streamed FID; one
   in-training FID at 200 samples, timed; ``vqgan512`` through ``sample``
   and ``eval-fid`` in bf16 (a run directory of its seeded state).

Then one ``kernels`` line (every kernel with its launches on its own path:
one CycleGAN training step and translate apply, or one VQGAN training step
and reconstruct apply for the attention kernels, ``launches_fit``, the
fit phase's run A, ``launches_per_bf16_translate_apply`` and
``launches_eval``, the eval phase's commands (not its timing loops),
``launches_cut`` and ``launches_dclgan``, one step of each contrastive
trainer of phase cut;
its error, and its times
and bound summed over that step; the top level is the fp32 step's, and
``per_dtype`` holds the same for each dtype in ``dtypes``, bf16 from the
``train_bf16`` step, with the design each dtype launched: "wgmma" on the
tensor cores, "mma" (the bf16 7x7 head), "tf32x3" (the fp32 conv3+IN,
K4s and the 7x7 head's forward), "one_launch" (the norm forward),
"two_pass" (the norm backward), or "fma", read from the
functions that the dtype's profiled training step launched and held to
``STEP_DESIGNS``; "tf32x3" for the attention kernels, read from each
dtype's VQGAN step's profile), the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# cuBLAS needs a fixed workspace to run deterministically (the train phase
# runs under torch.use_deterministic_algorithms); set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(ROOT, "src"))

PRESET = "cyclegan256_dp"
TRAIN_OVERRIDES = ["model.compute_dtype=float32", "loss.lambda_lpips=0"]
# cyclegan256_dp as published: bf16 compute, LPIPS on (lambda_lpips 1.0, the
# VGG drawn from seed 0, as without eval.vgg_weights)
TRAIN_OVERRIDES_BF16: list = []
LPIPS_OFF_STEPS = 10
BATCH = 8
SEED = 0
# H100 SXM data-sheet peaks (at 700 W): fp32 outside the tensor cores, bf16
# and TF32 dense on the tensor cores, HBM3. A bf16 case's bound counts the
# tensor-core rate, which only the kernels of designs "wgmma" and "mma"
# use; the others compute in fp32 FMAs. The attention kernels, the fp32
# conv3+IN, K4s's fp32 forward, dgrad and wgrad and the 7x7 head's fp32
# forward (design "tf32x3") multiply fp32 on the tensor cores in the
# three-term TF32 split: their bound counts 3 TF32 flops per fp32 flop at
# the TF32 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# Tolerances against the plain version on the card, on the error each case
# reports: max |kernel - plain| for outputs of O(1) (fp32 sums in another
# order over up to 9*256 and 49*64 terms); for sums over a whole batch and
# plane (the norm backward's dgamma/dbeta, the 7x7 wgrad) the error relative
# to the largest value; the augment kernel bit-equal (the same two roundings
# in the same order). Attention:
# each output's error relative to its largest value (softmax sums over 1024
# keys in another order, products in the three-term TF32 split; the fp32
# FMA design read 2.2e-6 forward, 3.0e-6 backward on an H100). Its cases
# also report both sides' error against float64 on the card. The fused
# conv3+IN in fp32 multiplies in the same split (design "tf32x3"), within
# the same 2e-4 of the plain version as its earlier FMA design.
# K4s: each output's error relative to its largest value (fp32 sums over
# up to 9 * 128 terms, or a batch's pixels for the weight gradient); the
# fp32 forward, dgrad and wgrad (design "tf32x3") are held to the same
# bounds as the FMA design before them, and report their error against
# float64 too; so is the 7x7 head's fp32 forward (1e-4, "tf32x3").
TOL = {"augment_batch": 0.0, "instance_norm": 1e-4,
       "instance_norm_bwd": 1e-4, "conv3_in_act": 2e-4, "conv7": 1e-4,
       "conv7_dgrad": 1e-4, "conv7_wgrad": 1e-4, "conv3s2": 1e-5,
       "conv3s2_dgrad": 1e-5, "conv3s2_wgrad": 1e-5,
       "attention_fwd": 1e-5, "attention_bwd": 1e-5}
# bf16 (both sides sum in fp32 from the same bf16 values and round once,
# in another order): in ulps of the largest magnitude of the plain output,
# ulp(M) = 2^(floor(log2 M) - 7); an output at a rounding boundary lands one
# ulp apart. conv3_in_act rounds twice in series (the conv output, then the
# normalized one), so one ulp of the first moves the second by up to two.
# The norm backward's dgamma/dbeta stay fp32: TOL's relative bound.
TOL_BF16 = {name: 1.0 for name in TOL} | {"conv3_in_act": 2.0,
                                          "augment_batch": 0.0}
# kernels whose every case must also repeat bit for bit
REPEAT_BIT_EQUAL = ("augment_batch", "instance_norm", "instance_norm_bwd",
                    "conv3_in_act",
                    "conv7", "conv7_dgrad", "conv7_wgrad", "conv3s2",
                    "conv3s2_dgrad", "conv3s2_wgrad", "attention_fwd",
                    "attention_bwd")
# design "tf32x3": the kernel's error against float64 at most this many
# times the plain version's (fp32 on the FMA cores), so that the split keeps
# fp32's order of error
FP64_ERR_OVER_PLAIN = 2.0
# The card-vs-CPU step at batch 1 (compare_card_cpu): the largest gradient
# gap allowed, relative to the network's largest gradient, and the largest
# gap the kernels may add (card with kernels against card with the plain
# versions) as a multiple of the gap that a one-ulp nudge of the parameters
# makes on the card. On an H100 (700 W), CycleGAN at 256²: the four pairs
# read 4.8e-3 to 6.7e-3 for G and 1.4e-3 to 1.6e-3 for D, the nudge alone
# 6.2e-3 and 1.6e-3. VQGAN at 512²: G 3.7e-3 to 5.0e-3 with the nudge at
# 5.0e-3; D's library convs (cuDNN against the CPU, no kernel involved)
# 3.4e-3 against a nudge of 1.0e-3, the kernels 7.9e-4. No fp32 pair of
# implementations agrees closer at these sizes, so the limits sit at 1.5x
# the largest reading and 2x the nudge's.
GRAD_GAP = 1e-2
# bf16 step at batch 1: the losses of two bf16 implementations (kernels or
# plain versions, card or CPU) within 2^-6 of their value, a few bf16 ulps
# of means over bf16 images; an H100 read at most 1.6e-3 (the adversarial
# and D losses, through D's LeakyReLU kinks).
LOSS_RTOL_BF16 = 2.0 ** -6
GRAD_GAP_OVER_FLOOR = 2.0
REPLACES = {
    "augment_batch": "src/uig/kernels/augment_pallas.py:117",
    "instance_norm": "src/uig/kernels/norm_pallas.py:127",
    "instance_norm_bwd": "src/uig/kernels/norm_pallas.py:145",
    "conv3_in_act": "src/uig/kernels/convin_pallas.py:141",
    "conv7": "src/uig/kernels/conv_pallas.py:209",
    "conv7_dgrad": "src/uig/kernels/conv_pallas.py:209",
    "conv7_wgrad": "src/uig/kernels/conv_pallas.py:273",
    "conv3s2": "src/uig/kernels/conv_pallas.py:209",
    "conv3s2_dgrad": "src/uig/kernels/conv_pallas.py:209",
    "conv3s2_wgrad": "src/uig/kernels/conv_pallas.py:273",
    "attention_fwd": "src/uig/kernels/attention_pallas.py:65",
    "attention_bwd": "src/uig/kernels/attention_pallas.py:142",
}
SOURCES = {
    "augment_batch": "src/uig_torch/csrc/augment.cu",
    "instance_norm": "src/uig_torch/csrc/instance_norm_fwd.cu",
    "instance_norm_bwd": "src/uig_torch/csrc/instance_norm_bwd.cu",
    "conv3_in_act": "src/uig_torch/csrc/conv3_in.cu",
    "conv7": "src/uig_torch/csrc/conv7.cu",
    "conv7_dgrad": "src/uig_torch/csrc/conv7_bwd.cu",
    "conv7_wgrad": "src/uig_torch/csrc/conv7_bwd.cu",
    "conv3s2": "src/uig_torch/csrc/conv3s2.cu",
    "conv3s2_dgrad": "src/uig_torch/csrc/conv3s2.cu",
    "conv3s2_wgrad": "src/uig_torch/csrc/conv3s2.cu",
    "attention_fwd": "src/uig_torch/csrc/attention.cu",
    "attention_bwd": "src/uig_torch/csrc/attention.cu",
}
# The kernels with more than one design: the CUDA function (or functions)
# that launch each design, and its source. Which design a dtype ran is read
# from the functions its profiled training step launched (``designs_run``);
# every other kernel has one design, "fma", in SOURCES. The earlier FMA
# designs of the fp32 conv3+IN, of the attention kernels and of K4s's fp32
# forward, dgrad and wgrad, the 7x7 head's FMA forward, dgrad and weight
# gradient (both types), the earlier six-launch norm backward and the
# three-launch norm forward (partials, finalize, apply; K3 still launches
# the last two, so its partials kernel names it), are gone from the source:
# their names stay here so that a step that launched them fails.
DESIGNS = {
    "instance_norm": {
        "three_pass": ("in_partials_kernel",
                       "src/uig_torch/csrc/instance_norm.cu"),
        "one_launch": ("in_fwd_kernel",
                       "src/uig_torch/csrc/instance_norm_fwd.cu")},
    "conv3_in_act": {
        "fma": ("conv3_gemm_kernel", "src/uig_torch/csrc/conv3_in.cu"),
        "wgmma": ("conv3_in_wgmma_kernel",
                  "src/uig_torch/csrc/conv3_in_tc.cu"),
        "tf32x3": (("conv3_wt_split_kernel", "conv3_in_tf32_wgmma_kernel"),
                   "src/uig_torch/csrc/conv3_in_tf32.cu")},
    "instance_norm_bwd": {
        "six_pass": (("in_bwd_stats_kernel", "in_bwd_partials_kernel",
                      "in_bwd_reduce_kernel", "in_bwd_params_kernel",
                      "in_bwd_apply_kernel"),
                     "src/uig_torch/csrc/instance_norm_bwd.cu"),
        "two_pass": (("in_bwd_sums_kernel", "in_bwd_dx_kernel"),
                     "src/uig_torch/csrc/instance_norm_bwd.cu")},
    "conv7": {
        "fma": ("conv7_kernel", "src/uig_torch/csrc/conv7.cu"),
        "mma": ("conv7_mma_kernel", "src/uig_torch/csrc/conv7_tc.cu"),
        "tf32x3": ("conv7_tf32_kernel", "src/uig_torch/csrc/conv7_tf32.cu")},
    "conv7_wgrad": {
        "fma": (("conv7_wgrad_kernel", "conv7_wgrad_reduce_kernel"),
                "src/uig_torch/csrc/conv7_bwd.cu"),
        "wgmma": (("conv7_wgrad_wgmma_kernel", "conv7_wgrad_sum_kernel"),
                  "src/uig_torch/csrc/conv7_wgrad_tc.cu"),
        "tf32x3": (("conv7_wgrad_tf32_kernel", "conv7_wgrad_tf32_sum_kernel"),
                   "src/uig_torch/csrc/conv7_wgrad_tf32.cu")},
    "conv3s2": {
        "fma": ("conv_fwd_kernel", "src/uig_torch/csrc/conv3s2.cu"),
        "wgmma": ("conv_fwd_wgmma_kernel", "src/uig_torch/csrc/conv3s2_tc.cu"),
        "tf32x3": (("conv_fwd_wsplit_kernel", "conv_fwd_tf32_kernel"),
                   "src/uig_torch/csrc/conv3s2_tf32.cu")},
    "conv7_dgrad": {
        "fma": ("conv7_dgrad_kernel", "src/uig_torch/csrc/conv7_bwd.cu"),
        "wgmma": ("conv7_dgrad_wgmma_kernel",
                  "src/uig_torch/csrc/conv7_bwd_tc.cu"),
        "tf32x3": ("conv7_dgrad_tf32_kernel",
                   "src/uig_torch/csrc/conv7_bwd_tf32.cu")},
    "conv3s2_dgrad": {
        "fma": ("conv_dgrad_kernel", "src/uig_torch/csrc/conv3s2.cu"),
        "wgmma": ("conv_dgrad_wgmma_kernel",
                  "src/uig_torch/csrc/conv3s2_tc.cu"),
        "tf32x3": (("conv_wsplit_kernel", "conv_dgrad_tf32_kernel"),
                   "src/uig_torch/csrc/conv3s2_tf32.cu")},
    "conv3s2_wgrad": {
        "fma": ("conv_wgrad_kernel", "src/uig_torch/csrc/conv3s2.cu"),
        "wgmma": ("conv_wgrad_wgmma_kernel",
                  "src/uig_torch/csrc/conv3s2_tc.cu"),
        "tf32x3": ("conv_wgrad_tf32_kernel",
                   "src/uig_torch/csrc/conv3s2_tf32.cu")},
    "attention_fwd": {
        "fma": ("attn_fwd_kernel", "src/uig_torch/csrc/attention.cu"),
        "tf32x3": ("attn_fwd_tc_kernel", "src/uig_torch/csrc/attention.cu")},
    "attention_bwd": {
        "fma": (("attn_dkdv_kernel", "attn_dq_kernel"),
                "src/uig_torch/csrc/attention.cu"),
        "tf32x3": (("attn_scores_tc_kernel", "attn_dv_tc_kernel",
                    "attn_dk_tc_kernel", "attn_dq_tc_kernel"),
                   "src/uig_torch/csrc/attention.cu")},
}


# The design each kernel of DESIGNS must run in one training step, by
# compute dtype (CycleGAN), and in the VQGAN step.
STEP_DESIGNS = {
    "float32": {"instance_norm": "one_launch",
                "instance_norm_bwd": "two_pass", "conv3_in_act": "tf32x3",
                "conv7": "tf32x3", "conv3s2": "tf32x3",
                "conv7_dgrad": "tf32x3", "conv7_wgrad": "tf32x3",
                "conv3s2_dgrad": "tf32x3",
                "conv3s2_wgrad": "tf32x3"},
    "bfloat16": {"instance_norm": "one_launch",
                 "instance_norm_bwd": "two_pass", "conv3_in_act": "wgmma",
                 "conv7": "mma", "conv3s2": "wgmma", "conv7_dgrad": "wgmma",
                 "conv7_wgrad": "wgmma", "conv3s2_dgrad": "wgmma",
                 "conv3s2_wgrad": "wgmma"}}
VQ_STEP_DESIGNS = {"instance_norm": "one_launch",
                   "instance_norm_bwd": "two_pass",
                   "attention_fwd": "tf32x3", "attention_bwd": "tf32x3"}


def design_functions(name: str, design: str) -> tuple:
    """The CUDA functions that launch ``design`` of kernel ``name``."""
    fns = DESIGNS[name][design][0]
    return (fns,) if isinstance(fns, str) else fns


def designs_run(calls: dict, phase: str, per_step: dict | None = None,
                expect: dict | None = None) -> dict:
    """{kernel: design} of the kernels in DESIGNS that one profiled training
    step launches (``per_step``, PER_STEP by default), from its launches by
    CUDA function (``calls``): the design each of whose functions launched
    per_step[kernel] times, while every other design's launched none. A
    kernel the step does not launch must have launched no function of any
    design. Raises otherwise, and if ``expect`` is given and differs."""
    per_step = PER_STEP if per_step is None else per_step
    out = {}
    for name, by_design in DESIGNS.items():
        seen = {d: [calls.get(fn, 0) for fn in design_functions(name, d)]
                for d in by_design}
        want = per_step[name]
        ran = [d for d, ns in seen.items() if any(ns)]
        if not want and not ran:
            continue
        if len(ran) != 1 or set(seen[ran[0]]) != {want}:
            raise AssertionError(
                f"{phase}: {name} launched {seen} by design in one step, "
                f"want one design's functions {want} times each")
        out[name] = ran[0]
    if expect is not None and out != expect:
        raise AssertionError(f"{phase}: designs {out}, want {expect}")
    return out


def design_calls(calls: dict) -> dict:
    """The launches of every function in DESIGNS, from ``calls``."""
    return {fn: calls.get(fn, 0) for name, by in DESIGNS.items()
            for d in by for fn in design_functions(name, d)}


PER_APPLY = {"augment_batch": 0, "instance_norm": 5, "instance_norm_bwd": 0,
             "conv3_in_act": 18, "conv7": 1, "conv7_dgrad": 0,
             "conv7_wgrad": 0, "conv3s2": 2, "conv3s2_dgrad": 0,
             "conv3s2_wgrad": 0, "attention_fwd": 0, "attention_bwd": 0}
# launches in one training step of cyclegan256_dp (fused applies), in fp32
# and in bf16 alike: 4 generator applies (2 at 2B, 2 at B) with 5 norms, 18
# conv3+IN, 2 downsamples and 1 head each; 4 discriminator applies (2 at B
# in the G loss, 2 at 2B in the D loss) with 3 norms each; every norm,
# conv3+IN, downsample and head is differentiated, and each conv3+IN
# backward runs the norm backward once.
PER_STEP = {"augment_batch": 2, "instance_norm": 32,
            "instance_norm_bwd": 32 + 72, "conv3_in_act": 72, "conv7": 4,
            "conv7_dgrad": 4, "conv7_wgrad": 4, "conv3s2": 8,
            "conv3s2_dgrad": 8, "conv3s2_wgrad": 8, "attention_fwd": 0,
            "attention_bwd": 0}
DTYPE_NAMES = ("float32", "bfloat16")
# The design each kernel of DESIGNS runs in one translate apply (fp32
# serving, PER_APPLY launches), read from a profiled apply.
SLICE_DESIGNS = {"instance_norm": "one_launch", "conv3_in_act": "tf32x3",
                 "conv7": "tf32x3", "conv3s2": "tf32x3"}

# Timed repeats, cut so that the whole run stays well inside its time
# limit (~211 s of command time on an H100 before the bf16 VQGAN phase):
# the kernel cases' CUDA-event repeats, the fp32 CycleGAN and the fp32
# VQGAN steps (shrink VQ_TRAIN_STEPS first if the run grows). The bf16
# CycleGAN phase keeps 20 steps, the bf16 VQGAN phase VQ_BF16_TRAIN_STEPS.
KERNEL_ITERS = 10
# profile_call's captures of one call at most (see there)
PROFILE_TRIES = 3
PROFILE_SPIN_MS = 50
FP32_TRAIN_STEPS = 10
VQ_TRAIN_STEPS = 6
VQ_BF16_TRAIN_STEPS = 10

VQ_PRESET = "vqgan512"
VQ_OVERRIDES = TRAIN_OVERRIDES + ["loss.vq_disc_start=0"]
# vqgan512 as published (bf16 compute, no LPIPS term), with D and the
# adaptive weight on from the first step
VQ_OVERRIDES_BF16 = ["loss.vq_disc_start=0"]
VQ_BATCH = 4  # per domain: the step trains on the union batch of 8
# launches in one reconstruct apply of vqgan512: 4 attention blocks (2 in
# the encoder, 2 in the decoder), each one K5f.
VQ_PER_APPLY = {k: 0 for k in PER_APPLY} | {"attention_fwd": 4}
# launches in one VQGAN training step: both augments; the 4 attention
# blocks forward once and backward once (the adaptive weight reads the main
# forward's graph); D (3 instance norms) on the reconstruction for the G
# loss and on the real and fake unions for the D loss; the norm backward
# runs for each of those 3 applies, and once more for the adversarial
# gradient at the decoder's last kernel.
VQ_PER_STEP = {k: 0 for k in PER_STEP} | {
    "augment_batch": 2, "instance_norm": 9, "instance_norm_bwd": 12,
    "attention_fwd": 4, "attention_bwd": 4}
# vqgan_slice, card against CPU at batch 1: the encoder output within
# VQ_TOL["z"] of its largest value; the decoder images from the same codes
# within VQ_TOL["image"] (absolute, images in [-1, 1]) and 1 uint8 step.
VQ_TOL = {"z": 1e-3, "image": 4e-3}


START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line carries the run's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def nvcc_version() -> str:
    """nvcc's release line, the toolkit the kernels were built with."""
    from uig_torch.kernels import _build

    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def host_ms(fn, iters: int) -> float:
    """The host's time to issue one call of ``fn`` (it returns before the
    card has run it), in ms: a host clock around ``iters`` calls in a row,
    the card idle before them."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, flops, dtype: str = "float32",
             design: str = "") -> tuple[float, str]:
    """The least time for the work, in ms, and what bounds it. ``flops``
    counts the function's own products; design "tf32x3" runs each as three
    TF32 products at the TF32 rate. In bf16 the attention kernels (design
    "tf32x3") give ``flops`` as (products of two bf16 operands, products of
    an fp32 and a bf16 operand): the first count at the bf16 rate, the
    second as two TF32 terms each at the TF32 rate."""
    if design == "tf32x3" and dtype == "bfloat16":
        pair, mixed = flops
        tf = pair / PEAK_BF16_FLOPS + 2.0 * mixed / PEAK_TF32_FLOPS
    elif design == "tf32x3":
        tf = 3.0 * flops / PEAK_TF32_FLOPS
    else:
        tf = flops / (PEAK_FP32_FLOPS if dtype == "float32"
                      else PEAK_BF16_FLOPS)
    tb = nbytes / PEAK_BYTES
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def max_err(a, b) -> float:
    d = (a.double() - b.double()).abs().max().item()
    if d != d:
        raise AssertionError("NaN in kernel output")
    return d


def bf16_ulp(m: float) -> float:
    """One bf16 ulp at magnitude m: 2^(floor(log2 m) - 7)."""
    return 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def _abs_check(out, ref):
    err = max_err(out, ref)
    return err, err, {}


def _rel_check(out, ref):
    err = max_err(out, ref)
    return err, err / max(ref.abs().max().item(), 1e-30), {}


def _ulp_check(out, ref):
    """bf16: the error in ulps of the plain output's largest magnitude."""
    err = max_err(out, ref)
    return err, err / bf16_ulp(ref.abs().max().item()), {}


def _norm_bwd_check(x, g, b, dy, relu):
    """The norm backward's three outputs against the plain version's. With
    a fused ReLU, an element whose recomputed pre-activation lies within
    1e-4 of 0 sits at the kink, where either side is right: dx is compared
    elsewhere, and dgamma/dbeta are held per channel to the tolerance plus
    what those elements can move them by, sum |dy x_hat| and sum |dy| over
    them. dgamma and dbeta relative to their max; in bf16, dx in ulps of its
    largest magnitude and dgamma/dbeta (fp32) as the fraction of their fp32
    tolerance, so that 1 is the limit of each."""
    import torch

    from uig_torch.kernels import instance_norm_reference

    keep, slack_g, slack_b = None, 0.0, 0.0
    if relu:
        xn = instance_norm_reference(x.float(), torch.ones_like(g),
                                     torch.zeros_like(b))
        kink = (xn * g + b).abs() < 1e-4
        keep = ~kink
        dyk = torch.where(kink, dy.float(), 0.0)
        slack_b = dyk.abs().sum(dim=(0, 1, 2))
        slack_g = (dyk * xn).abs().sum(dim=(0, 1, 2))
        del xn, dyk
    bf16 = x.dtype == torch.bfloat16

    def check(out, ref):
        dx, dg, db = out
        rdx, rdg, rdb = ref
        if keep is not None:
            dx, rdx = dx[keep], rdx[keep]
        ex = max_err(dx, rdx)
        eg, eb = max_err(dg, rdg), max_err(db, rdb)
        sg = max(rdg.abs().max().item(), 1e-30)
        sb = max(rdb.abs().max().item(), 1e-30)
        rg = ((dg - rdg).abs() - slack_g).clamp(min=0).max().item() / sg
        rb = ((db - rdb).abs() - slack_b).clamp(min=0).max().item() / sb
        if bf16:
            tol = TOL["instance_norm_bwd"]
            checked = max(ex / bf16_ulp(rdx.abs().max().item()), rg / tol,
                          rb / tol)
        else:
            checked = max(ex, rg, rb)
        extra = {"dx_elements_at_relu_kink": (
            0 if keep is None else int((~keep).sum().item()))}
        if keep is not None:
            extra["kink_slack_rel"] = {
                "dgamma": float(slack_g.max()) / sg,
                "dbeta": float(slack_b.max()) / sb}
        return max(ex, eg, eb), checked, extra
    return check


def _multi_rel_check(outs, refs):
    """Several outputs: the largest error of each relative to its own
    largest value."""
    errs = [max_err(o, r) for o, r in zip(outs, refs)]
    rels = [e / max(r.abs().max().item(), 1e-30) for e, r in zip(errs, refs)]
    return max(errs), max(rels), {}


def _attention_bf16_check(name, widened_kernel, widened_plain):
    """bf16 attention (K5f, K5b): each bf16 output within TOL_BF16 ulps of
    the plain version's largest magnitude; the fp32 kernel on the widened
    inputs within the fp32 gate (TOL, of each output's largest value) of
    the plain version there; and each output of the bf16 kernel bit-equal
    to that fp32 kernel's, rounded once (the forward's fp32 o unrounded): a
    bf16 operand is exact in TF32, so the bf16 design drops only products
    with exact zeros. ``checked`` is the larger error as a fraction of its
    limit, so that 1 is the limit of each."""
    import torch

    def check(out, ref):
        outs, refs = _outputs(out), _outputs(ref)
        wk, wp = _outputs(widened_kernel()), _outputs(widened_plain())
        n = len(wk)
        err = max(max_err(o, r) for o, r in zip(outs[:n], refs[:n]))
        ulps = max(max_err(o, r) / bf16_ulp(r.abs().max().item())
                   for o, r in zip(outs[:n], refs[:n]))
        rel32 = max(max_err(a, b) / max(b.abs().max().item(), 1e-30)
                    for a, b in zip(wk, wp))
        pairs = list(zip(outs[:n], wk)) + list(zip(outs[n:], wk))
        if not all(torch.equal(o, w.to(o.dtype)) for o, w in pairs):
            raise AssertionError(f"{name} bfloat16: not bit-equal to the "
                                 f"fp32 kernel on the widened inputs")
        return err, max(ulps / TOL_BF16[name], rel32 / TOL[name]), {
            "bf16_ulps": ulps, "fp32_kernel_widened_rel_err": rel32,
            "bit_equal_fp32_kernel_widened": True}
    return check


def _case(name, label, step, apply, fn, plain, lib, nbytes, flops,
          check=_abs_check, path="cyclegan", dtype="float32", tol=None,
          design="", fp64=None):
    """One kernel case; ``fp64``, where given, computes the function in
    float64 on the card for the errors against it."""
    if dtype == "bfloat16" and check in (_abs_check, _rel_check):
        check = _ulp_check
    if tol is None or dtype != "float32":
        tol = (TOL if dtype == "float32" else TOL_BF16)[name]
    return {"name": name, "case": label, "step": step, "apply": apply,
            "fn": fn, "plain": plain, "lib": lib, "bytes": nbytes,
            "flops": flops, "check": check, "path": path, "dtype": dtype,
            "tol": tol, "design": design, "fp64": fp64}


def _outputs(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _bit_equal(a, b) -> bool:
    import torch

    return all(torch.equal(u, v) for u, v in zip(_outputs(a), _outputs(b)))


def fp64_errs(out, plain, exact) -> dict:
    """The kernel's and the plain version's largest error against the
    float64 computation, each relative to the largest value of that output
    (the unit of the attention gates)."""
    errs = {"err_fp64": 0.0, "plain_err_fp64": 0.0}
    for key, got in (("err_fp64", out), ("plain_err_fp64", plain)):
        for g, e in zip(_outputs(got), _outputs(exact)):
            errs[key] = max(errs[key], max_err(g, e) / e.abs().max().item())
    return errs


def conv3_in_fp64(x, w, b, g, be, relu):
    """The reflect-padded conv3 + bias + instance norm (+ReLU) in float64,
    NHWC."""
    import torch
    import torch.nn.functional as F

    xn = F.pad(x.double().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.conv2d(xn, w.double().permute(3, 2, 0, 1), b.double())
    y = F.instance_norm(y, weight=g.double(), bias=be.double(), eps=1e-5)
    return (torch.relu(y) if relu else y).permute(0, 2, 3, 1)


def conv7_fp64(x, w, b, pad_mode):
    """The 7x7 pad-3 conv (reflect or zeros) + bias in float64, NHWC."""
    import torch.nn.functional as F

    if pad_mode == "zeros":
        return conv_fwd_fp64(x, w, b, 1, 3)
    xp = F.pad(x.double().permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect")
    return conv_fwd_fp64(xp.permute(0, 2, 3, 1), w, b, 1, 0)


def conv7_dgrad_fp64(dy, w, pad_mode):
    """conv7's input gradient in float64, NHWC, the reflect ring folded
    onto its sources in float64."""
    from uig_torch.kernels.reflect import reflect_fold

    if pad_mode == "zeros":
        return conv_dgrad_fp64(dy, w, dy.shape[1:3], 1, 3)
    size = (dy.shape[1] + 6, dy.shape[2] + 6)
    return reflect_fold(conv_dgrad_fp64(dy, w, size, 1, 0), 3)


def conv7_wgrad_fp64(x, dy, pad_mode):
    """conv7's weight gradient in float64, against the reflect-padded (or
    zero-padded) x."""
    import torch.nn.functional as F

    if pad_mode == "zeros":
        return conv_wgrad_fp64(x, dy, 7, 1, 3)
    xp = F.pad(x.double().permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect")
    return conv_wgrad_fp64(xp.permute(0, 2, 3, 1), dy, 7, 1, 0)


def conv_fwd_fp64(x, w, b, stride, pad):
    """The zero-padded strided conv + bias in float64, NHWC: x (B, H, W,
    C), w (k, k, C, F), b (F,) or None -> y (B, Ho, Wo, F)."""
    import torch.nn.functional as F

    y = F.conv2d(x.double().permute(0, 3, 1, 2),
                 w.double().permute(3, 2, 0, 1),
                 None if b is None else b.double(), stride=stride,
                 padding=pad)
    return y.permute(0, 2, 3, 1)


def conv_dgrad_fp64(dy, w, size, stride, pad):
    """The input gradient of the zero-padded strided conv in float64, NHWC:
    dy (B, Ho, Wo, F), w (k, k, C, F) -> dx (B, H, W, C), (H, W) = size."""
    import torch

    dx = torch.nn.grad.conv2d_input(
        (dy.shape[0], w.shape[2]) + tuple(size),
        w.double().permute(3, 2, 0, 1), dy.double().permute(0, 3, 1, 2),
        stride=stride, padding=pad)
    return dx.permute(0, 2, 3, 1)


def conv_wgrad_fp64(x, dy, k, stride, pad):
    """Its weight gradient in float64: x (B, H, W, C), dy -> dw (k, k, C,
    F)."""
    import torch

    dw = torch.nn.grad.conv2d_weight(
        x.double().permute(0, 3, 1, 2), (dy.shape[3], x.shape[3], k, k),
        dy.double().permute(0, 3, 1, 2), stride=stride, padding=pad)
    return dw.permute(2, 3, 1, 0)


def attention_fp64(q, k, v, do=None):
    """Attention in float64: o, or (dq, dk, dv) for the output gradient
    ``do``."""
    q, k, v = (t.double() for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    p = (q @ k.transpose(1, 2) * scale).softmax(-1)
    if do is None:
        return p @ v
    do = do.double()
    dp = do @ v.transpose(1, 2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (scale * ds @ k, scale * ds.transpose(1, 2) @ q,
            p.transpose(1, 2) @ do)


def kernel_cases(dev, dtype: str = "float32"):
    """Yield one case per kernel and shape of the training step and the
    translate apply of its path (CycleGAN, or VQGAN for attention) in
    ``dtype``: calls per training step and per translate apply, the kernel,
    its plain version, a library call, bytes and flops."""
    import torch
    import torch.nn.functional as F

    from uig_torch.kernels import (attention_bwd, attention_bwd_reference,
                                   attention_fwd, attention_reference,
                                   augment_batch, augment_batch_reference,
                                   conv3_in_act, conv3_in_act_reference,
                                   conv3s2, conv3s2_dgrad,
                                   conv3s2_dgrad_reference, conv3s2_reference,
                                   conv3s2_wgrad, conv3s2_wgrad_reference,
                                   conv7, conv7_dgrad, conv7_dgrad_reference,
                                   conv7_reference, conv7_wgrad,
                                   conv7_wgrad_reference, conv_core,
                                   conv_core_reference, instance_norm,
                                   instance_norm_bwd,
                                   instance_norm_bwd_reference,
                                   instance_norm_reference)
    from uig_torch.kernels import conv_s2
    from uig_torch.kernels.norm import _instance_norm_fwd

    dt = getattr(torch, dtype)
    f32 = dtype == "float32"
    isz = 4.0 if f32 else 2.0
    g = torch.Generator(device="cpu").manual_seed(SEED)
    g_dev = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, shift=0.0, t=dt):
        return (torch.randn(*shape, generator=g) * scale + shift).to(dev, t)

    def randn_dev(*shape, scale=1.0, shift=0.0, t=dt):
        """Drawn on the card (the norm cases' large planes)."""
        return (torch.randn(*shape, generator=g_dev, device=dev) * scale
                + shift).to(t)

    def case(*args, **kw):
        return _case(*args, dtype=dtype, **kw)

    # K1: both uint8 batches of a step
    rng = np.random.default_rng(SEED)
    load, crop = 286, 256
    u8 = torch.from_numpy(rng.integers(0, 256, (BATCH, load, load, 3),
                                       dtype=np.uint8)).to(dev)
    oy = torch.from_numpy(rng.integers(0, load - crop + 1, BATCH))
    ox = torch.from_numpy(rng.integers(0, load - crop + 1, BATCH))
    flip = torch.from_numpy(rng.integers(0, 2, BATCH).astype(bool))
    ar = torch.arange(crop, device=dev)
    rows = oy.to(dev)[:, None] + ar
    cols = ox.to(dev)[:, None] + torch.where(flip.to(dev)[:, None],
                                             crop - 1 - ar, ar)
    bidx = torch.arange(BATCH, device=dev)[:, None, None]
    yield case("augment_batch", f"({BATCH},{load},{load},3)->{crop}", 2, 0,
               lambda: augment_batch(u8, oy, ox, flip, crop, dt),
               lambda: augment_batch_reference(u8, oy, ox, flip, crop, dt),
               lambda: (u8[bidx, rows[:, :, None], cols[:, None, :]].float()
                        * (2.0 / 255.0) - 1.0).to(dt),
               (1.0 + isz) * BATCH * crop * crop * 3,  # crops read, out
               2.0 * BATCH * crop * crop * 3)
    del u8

    # instance norm forward and backward: generator norms (+ReLU) and
    # discriminator norms; (shape, relu, per apply at batch 8, per step
    # for each of batch 2B and B, the norm backward's extra calls per step
    # from the conv3+IN backward for each batch)
    norms = [((256, 64), True, 2, 4, 0), ((128, 128), True, 2, 4, 0),
             ((64, 256), True, 1, 2, 18), ((64, 256), False, 0, 0, 18),
             ((64, 128), False, 0, 2, 0), ((32, 256), False, 0, 2, 0),
             ((31, 512), False, 0, 2, 0)]
    # the contrastive trainers' tap on d128's norm (CUT, FastCUT and DCLGAN
    # as published, batch 16): the norm without its ReLU, and its backward
    # on that tap's cotangent; on no CycleGAN step or apply
    taps = [((128, 128), False, 0, 0, 0)]
    for nb, (h, c), relu, per_apply, per_step, conv_bwd, path in (
            [(nb, *n, "cyclegan") for nb in (2 * BATCH, BATCH)
             for n in norms] + [(2 * BATCH, *n, "cut") for n in taps]):
        x = randn_dev(nb, h, h, c, scale=2.0, shift=0.5)
        ga = randn_dev(c, scale=0.1, shift=1.0, t=torch.float32)
        be = randn_dev(c, scale=0.1, t=torch.float32)
        n = x.numel()
        label = f"({nb},{h},{h},{c}) relu={relu}"
        if per_step or path == "cut":
            yield case(
                "instance_norm", label, per_step,
                per_apply if nb == BATCH else 0,
                lambda x=x, ga=ga, be=be, r=relu: instance_norm(
                    x, ga, be, relu=r),
                lambda x=x, ga=ga, be=be, r=relu: instance_norm_reference(
                    x, ga, be, relu=r),
                lambda x=x, ga=ga, be=be: F.instance_norm(
                    x.permute(0, 3, 1, 2), weight=ga, bias=be, eps=1e-5),
                2 * isz * n, 6.0 * n, path=path)
        dy = randn_dev(nb, h, h, c)
        stats = _instance_norm_fwd(x, ga, be, 1e-5, relu)[1]
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
        gl = ga.detach().requires_grad_(True)
        bl = be.detach().requires_grad_(True)
        yl = F.instance_norm(xl, weight=gl, bias=bl, eps=1e-5)
        if relu:
            yl = torch.relu(yl)
        dyl = dy.permute(0, 3, 1, 2)
        yield case(
            "instance_norm_bwd", label, per_step + conv_bwd, 0,
            lambda x=x, ga=ga, be=be, dy=dy, st=stats, r=relu:
            instance_norm_bwd(x, ga, be, dy, st, relu=r),
            lambda x=x, ga=ga, be=be, dy=dy, st=stats, r=relu:
            instance_norm_bwd_reference(x, ga, be, dy, st, relu=r),
            lambda yl=yl, xl=xl, gl=gl, bl=bl, dyl=dyl: torch.autograd.grad(
                yl, (xl, gl, bl), dyl, retain_graph=True),
            3 * isz * n, 14.0 * n,
            check=_norm_bwd_check(x, ga, be, dy, relu), path=path)
        del x, dy, xl, yl, stats
    # conv3 + IN forward: the 18 trunk pairs of each apply, half with ReLU;
    # fp32 in the three-term TF32 split, held against float64 too
    h, c = 64, 256
    w = randn(3, 3, c, c, scale=0.02)
    b, ga, be = (randn(c, scale=0.02, t=torch.float32),
                 randn(c, scale=0.1, shift=1.0, t=torch.float32),
                 randn(c, scale=0.1, t=torch.float32))
    for nb in (2 * BATCH, BATCH):
        x = randn(nb, h, h, c)
        flops = 2.0 * nb * h * h * c * 9 * c
        nbytes = isz * (2 * x.numel() + w.numel()) + 4.0 * 3 * c
        for relu in (True, False):
            yield case(
                "conv3_in_act", f"({nb},{h},{h},{c})->{c} reflect relu={relu}",
                18, 9 if nb == BATCH else 0,
                lambda x=x, relu=relu: conv3_in_act(x, w, b, ga, be, relu=relu),
                lambda x=x, relu=relu: conv3_in_act_reference(
                    x, w, b, ga, be, relu=relu),
                lambda x=x: F.instance_norm(F.conv2d(
                    F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
                    w.permute(3, 2, 0, 1), b.to(dt)), weight=ga, bias=be,
                    eps=1e-5),
                nbytes, flops,
                design="tf32x3" if f32 else "",
                fp64=(lambda x=x, relu=relu: conv3_in_fp64(
                    x, w, b, ga, be, relu)) if f32 else None)
        del x
    # the 7x7 head: forward, dgrad, wgrad at both batches, and all three
    # with zeros padding at a smaller shape (not on the path); fp32 in the
    # three-term TF32 split, held against float64 too
    w = randn(7, 7, 64, 3, scale=0.02)
    b = randn(3, scale=0.02)
    wt = w.permute(3, 2, 0, 1)
    for nb, h, mode, per_step, per_apply in (
            (2 * BATCH, 256, "reflect", 2, 0), (BATCH, 256, "reflect", 2, 1),
            (2, 64, "zeros", 0, 0)):
        x = randn(nb, h, h, 64)
        flops = 2.0 * nb * h * h * 3 * 49 * 64
        label = f"({nb},{h},{h},64)->3 {mode}"
        pad = ((lambda t: F.pad(t, (3, 3, 3, 3), mode="reflect"))
               if mode == "reflect" else (lambda t: F.pad(t, (3, 3, 3, 3))))
        yield case("conv7", label, per_step, per_apply,
                   lambda x=x, mode=mode: conv7(x, w, b, mode),
                   lambda x=x, mode=mode: conv7_reference(x, w, b, mode),
                   lambda x=x, pad=pad: F.conv2d(pad(x.permute(0, 3, 1, 2)),
                                                 wt, b),
                   isz * (x.numel() + w.numel() + 3 + nb * h * h * 3), flops,
                   design="tf32x3" if f32 else "",
                   fp64=(lambda x=x, mode=mode: conv7_fp64(x, w, b, mode))
                   if f32 else None)
        dy = randn(nb, h, h, 3)
        dyn = dy.permute(0, 3, 1, 2)
        hp = h + 6 if mode == "reflect" else h
        yield case("conv7_dgrad", label, per_step, 0,
                   lambda dy=dy, mode=mode: conv7_dgrad(dy, w, mode),
                   lambda dy=dy, mode=mode: conv7_dgrad_reference(dy, w, mode),
                   lambda dyn=dyn, nb=nb, hp=hp, p=(3 if hp == h else 0):
                   torch.nn.grad.conv2d_input((nb, 64, hp, hp), wt, dyn,
                                              padding=p),
                   isz * (dy.numel() + w.numel() + x.numel()), flops,
                   design="tf32x3" if f32 else "",
                   fp64=(lambda dy=dy, mode=mode: conv7_dgrad_fp64(
                       dy, w, mode)) if f32 else None)
        yield case("conv7_wgrad", label, per_step, 0,
                   lambda x=x, dy=dy, mode=mode: conv7_wgrad(x, dy, mode),
                   lambda x=x, dy=dy, mode=mode: conv7_wgrad_reference(
                       x, dy, mode),
                   lambda x=x, dyn=dyn, pad=pad: torch.nn.grad.conv2d_weight(
                       pad(x.permute(0, 3, 1, 2)), (3, 64, 7, 7), dyn),
                   isz * (x.numel() + dy.numel() + w.numel()), flops,
                   check=_rel_check, design="tf32x3" if f32 else "",
                   fp64=(lambda x=x, dy=dy, mode=mode: conv7_wgrad_fp64(
                       x, dy, mode)) if f32 else None)
        del x, dy, dyn
    # K4s: the downsamples d128 (256^2, 64 -> 128) and d256 (128^2, 128 ->
    # 256) of each generator apply, forward, dgrad and wgrad at both
    # batches; then conv_core, the VALID stride-1 conv, at one 3x3 shape
    # (not on the path)
    for nb in (2 * BATCH, BATCH):
        for h, cin, cout in ((256, 64, 128), (128, 128, 256)):
            x = randn(nb, h, h, cin)
            w = randn(3, 3, cin, cout, scale=0.05)
            b = randn(cout, scale=0.05)
            dy = randn(nb, h // 2, h // 2, cout)
            xn, wt, dyn = (x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                           dy.permute(0, 3, 1, 2))
            flops = 2.0 * nb * (h // 2) ** 2 * cout * 9 * cin
            label = f"({nb},{h},{h},{cin})->{cout} s2"
            yield case("conv3s2", label, 2, 1 if nb == BATCH else 0,
                       lambda x=x, w=w, b=b: conv3s2(x, w, b),
                       lambda x=x, w=w, b=b: conv3s2_reference(x, w, b),
                       lambda xn=xn, wt=wt, b=b: F.conv2d(
                           xn, wt, b, stride=2, padding=1),
                       isz * (x.numel() + w.numel() + cout + dy.numel()),
                       flops, check=_rel_check, design="tf32x3" if f32 else "",
                       fp64=(lambda x=x, w=w, b=b: conv_fwd_fp64(
                           x, w, b, 2, 1)) if f32 else None)
            yield case("conv3s2_dgrad", label, 2, 0,
                       lambda dy=dy, w=w: conv3s2_dgrad(dy, w),
                       lambda dy=dy, w=w: conv3s2_dgrad_reference(dy, w),
                       lambda dyn=dyn, wt=wt, shape=xn.shape:
                       torch.nn.grad.conv2d_input(shape, wt, dyn, stride=2,
                                                  padding=1),
                       isz * (dy.numel() + w.numel() + x.numel()), flops,
                       check=_rel_check, design="tf32x3" if f32 else "",
                       fp64=(lambda dy=dy, w=w, h=h: conv_dgrad_fp64(
                           dy, w, (h, h), 2, 1)) if f32 else None)
            yield case("conv3s2_wgrad", label, 2, 0,
                       lambda x=x, dy=dy: conv3s2_wgrad(x, dy),
                       lambda x=x, dy=dy: conv3s2_wgrad_reference(x, dy),
                       lambda xn=xn, dyn=dyn, shape=wt.shape:
                       torch.nn.grad.conv2d_weight(xn, shape, dyn, stride=2,
                                                   padding=1),
                       isz * (x.numel() + dy.numel() + w.numel()), flops,
                       check=_rel_check, design="tf32x3" if f32 else "",
                       fp64=(lambda x=x, dy=dy: conv_wgrad_fp64(
                           x, dy, 3, 2, 1)) if f32 else None)
            del x, dy, xn, dyn
    xp = randn(2, 66, 66, 64)
    wf = randn(9 * 64, 64, scale=0.05)
    w4 = wf.reshape(3, 3, 64, 64)
    dy = randn(2, 64, 64, 64)
    xn, wt, dyn = xp.permute(0, 3, 1, 2), w4.permute(3, 2, 0, 1), \
        dy.permute(0, 3, 1, 2)
    flops = 2.0 * 2 * 64 * 64 * 64 * 9 * 64
    label = "conv_core (2,66,66,64)->64 3x3 VALID (not on the path)"
    # the plain version's weight gradient here is cuDNN's deterministic fp32
    # VALID wgrad, which read 1.4e-5 of the largest value from the FMA
    # kernel on an H100 (the stride-2 cases read 1.3e-6 to 1.8e-6): 5e-5
    core_tol = 5e-5
    yield case("conv3s2", label, 0, 0, lambda: conv_core(xp, wf, 3, 3),
               lambda: conv_core_reference(xp, wf, 3, 3),
               lambda: F.conv2d(xn, wt),
               isz * (xp.numel() + wf.numel() + dy.numel()), flops,
               check=_rel_check, design="tf32x3" if f32 else "",
               fp64=(lambda: conv_fwd_fp64(xp, w4, None, 1, 0))
               if f32 else None)
    yield case("conv3s2_dgrad", label, 0, 0,
               lambda: conv_s2._dgrad("conv_core", dy, w4, (66, 66), 1, 0),
               lambda: conv_s2._dgrad_reference(dy, w4, (66, 66), 1, 0),
               lambda: torch.nn.grad.conv2d_input(xn.shape, wt, dyn),
               isz * (xp.numel() + wf.numel() + dy.numel()), flops,
               check=_rel_check, design="tf32x3" if f32 else "",
               fp64=(lambda: conv_dgrad_fp64(dy, w4, (66, 66), 1, 0))
               if f32 else None)
    yield case("conv3s2_wgrad", label, 0, 0,
               lambda: conv_s2._wgrad("conv_core", xp, dy, 3, 1, 0),
               lambda: conv_s2._wgrad_reference(xp, dy, 3, 1, 0),
               lambda: torch.nn.grad.conv2d_weight(xn, wt.shape, dyn),
               isz * (xp.numel() + wf.numel() + dy.numel()), flops,
               check=_rel_check, tol=core_tol,
               design="tf32x3" if f32 else "",
               fp64=(lambda: conv_wgrad_fp64(xp, dy, 3, 1, 0))
               if f32 else None)
    del xp, dy, xn, dyn

    # K5f at the reconstruct apply's batch 4 (where _key_splits takes two
    # key ranges and the combine kernel) and the VQGAN step's union batch
    # 8, K5b at the step's: (B, 1024, 512), the 32² latent grid of a 512²
    # image at 512 channels. In bf16 the fp32 kernel on the widened inputs
    # and the plain version there are the check's yardsticks; the batch-4
    # forward is on no bf16 path (the reconstruct apply runs fp32).
    n, d = 1024, 512
    for nb, per_step, per_apply in ((VQ_BATCH, 0, 4 if f32 else 0),
                                    (2 * VQ_BATCH, 4, 0)):
        q, k, v, do = (randn(nb, n, d) for _ in range(4))
        label = f"({nb},{n},{d})"
        w32 = [t.float() for t in (q, k, v, do)]
        if f32:
            yield case("attention_fwd", label, per_step, per_apply,
                       lambda q=q, k=k, v=v: attention_fwd(q, k, v)[0],
                       lambda q=q, k=k, v=v: attention_reference(q, k, v),
                       lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                           q, k, v),
                       4.0 * (4 * q.numel() + nb * n), 4.0 * nb * n * n * d,
                       check=_rel_check, path="vqgan", design="tf32x3",
                       fp64=lambda q=q, k=k, v=v: attention_fp64(q, k, v))
        else:  # (o, o32): the output and the backward's fp32 residual
            yield case("attention_fwd", label, per_step, per_apply,
                       lambda q=q, k=k, v=v: attention_fwd(q, k, v)[::2],
                       lambda w=w32: (lambda o: (o.to(torch.bfloat16), o))(
                           attention_reference(*w[:3])),
                       lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                           q, k, v),
                       2.0 * 4 * q.numel() + 4.0 * (q.numel() + nb * n),
                       (2.0 * nb * n * n * d, 2.0 * nb * n * n * d),
                       check=_attention_bf16_check(
                           "attention_fwd",
                           lambda w=w32: attention_fwd(*w[:3])[0],
                           lambda w=w32: attention_reference(*w[:3])),
                       path="vqgan", design="tf32x3")
        if not per_step:
            continue
        _, lse, o32 = attention_fwd(q, k, v)
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        lib = (lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                           retain_graph=True))
        if f32:
            yield case("attention_bwd", label, per_step, 0,
                       lambda: attention_bwd(q, k, v, o32, lse, do),
                       lambda: attention_bwd_reference(q, k, v, do), lib,
                       4.0 * (8 * q.numel() + nb * n), 10.0 * nb * n * n * d,
                       check=_multi_rel_check, path="vqgan", design="tf32x3",
                       fp64=lambda: attention_fp64(q, k, v, do))
        else:
            _, lse32, o32_32 = attention_fwd(*w32[:3])
            yield case("attention_bwd", label, per_step, 0,
                       lambda: attention_bwd(q, k, v, o32, lse, do),
                       lambda: attention_bwd_reference(q, k, v, do), lib,
                       2.0 * 7 * q.numel() + 4.0 * (q.numel() + nb * n),
                       (4.0 * nb * n * n * d, 6.0 * nb * n * n * d),
                       check=_attention_bf16_check(
                           "attention_bwd",
                           lambda: attention_bwd(*w32[:3], o32_32, lse32,
                                                 w32[3]),
                           lambda: attention_bwd_reference(*w32)),
                       path="vqgan", design="tf32x3")


def conv3_backward_parts(dev):
    """The library convs of the conv3+IN backward at the step's shapes,
    timed with their bound: (label, calls per step, fn, bytes, flops)."""
    import torch

    from uig_torch.kernels.convin import conv3_dgrad, conv3_wgrad

    g = torch.Generator(device="cpu").manual_seed(SEED)
    h, c = 64, 256
    w = (torch.randn(3, 3, c, c, generator=g) * 0.02).to(dev)
    for nb in (2 * BATCH, BATCH):
        x = torch.randn(nb, h, h, c, generator=g).to(dev)
        dyc = torch.randn(nb, h, h, c, generator=g).to(dev)
        flops = 2.0 * nb * h * h * c * 9 * c
        yield (f"conv3_dgrad ({nb},{h},{h},{c}) reflect", 36,
               lambda dyc=dyc: conv3_dgrad(dyc, w, "reflect"),
               4.0 * (2 * dyc.numel() + w.numel()), flops)
        yield (f"conv3_wgrad ({nb},{h},{h},{c}) reflect", 36,
               lambda x=x, dyc=dyc: conv3_wgrad(x, dyc, "reflect"),
               4.0 * (x.numel() + dyc.numel() + w.numel()), flops)
        del x, dyc


def phase_kernels(dev) -> dict:
    """Every case in fp32 and in bf16: checked against its plain version,
    timed beside it, the library call and the bound. Returns totals by
    (kernel, dtype), each summed over one step and one apply."""
    import torch

    from uig_torch.serving import exact_fp32

    totals = {}
    with exact_fp32():
        for dtype in DTYPE_NAMES:
            for c in kernel_cases(dev, dtype):
                name = c["name"]
                out = c["fn"]()
                err, checked, extra = c["check"](out, c["plain"]())
                if checked > c["tol"]:
                    raise AssertionError(
                        f"{name} {dtype} {c['case']}: error {checked} > tol "
                        f"{c['tol']}")
                if name in REPEAT_BIT_EQUAL:
                    if not _bit_equal(c["fn"](), out):
                        raise AssertionError(
                            f"{name} {dtype} {c['case']}: a repeat differs")
                    extra["repeat_bit_equal"] = True
                if c["fp64"] is not None:
                    extra.update(fp64_errs(out, c["plain"](), c["fp64"]()))
                    if extra["err_fp64"] > (FP64_ERR_OVER_PLAIN
                                            * extra["plain_err_fp64"]):
                        raise AssertionError(
                            f"{name} {dtype} {c['case']}: error from float64 "
                            f"{extra['err_fp64']} > {FP64_ERR_OVER_PLAIN} x "
                            f"the plain version's {extra['plain_err_fp64']}")
                    # the precision the yardstick runs at: its CUDA kernels
                    extra["library_kernels"] = sorted(profile_call(
                        c["lib"], "library", calls=True)["calls"])
                del out
                ms, plain_ms, lib_ms = (cuda_ms(c[k], KERNEL_ITERS, 2)
                                        for k in ("fn", "plain", "lib"))
                # the kernels' own device time in one call: ms above times
                # back-to-back calls, which the host's issue rate bounds
                # for the small kernels
                device_ms = profile_call(c["fn"], "device")["device_busy_ms"]
                issue_ms = host_ms(c["fn"], KERNEL_ITERS)
                bms, by = bound_ms(c["bytes"], c["flops"], dtype, c["design"])
                emit({"phase": "kernel", "name": name, "dtype": dtype,
                      "case": c["case"], "path": c["path"],
                      "calls_per_step": c["step"],
                      "calls_per_apply": c["apply"],
                      "max_abs_err": err, "checked_err": checked,
                      "tol": c["tol"],
                      "tol_unit": ("bf16 ulp" if dtype == "bfloat16"
                                   else "as TOL"),
                      "ms": ms, "device_ms": device_ms, "host_ms": issue_ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bms, "bound_by": by, **extra})
                t = totals.setdefault((name, dtype), {
                    "max_abs_err": 0.0, "bound_by": by, "step": {},
                    "apply": {}})
                t["max_abs_err"] = max(t["max_abs_err"], err)
                if c["step"]:
                    t["bound_by"] = by
                for per in ("step", "apply"):
                    acc = t[per]
                    for k, v in (("ms", ms), ("device_ms", device_ms),
                                 ("host_ms", issue_ms),
                                 ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms), ("bound_ms", bms)):
                        if isinstance(v, str) and c[per]:  # "not measured"
                            acc[k] = v
                        elif not isinstance(acc.get(k), str):
                            acc[k] = acc.get(k, 0.0) + c[per] * (
                                0.0 if isinstance(v, str) else v)
        parts = {"ms": 0.0, "bound_ms": 0.0}
        for label, calls, fn, nbytes, flops in conv3_backward_parts(dev):
            ms = cuda_ms(fn, KERNEL_ITERS, 2)
            bms, by = bound_ms(nbytes, flops)
            emit({"phase": "conv3_backward_library", "case": label,
                  "calls_per_step": calls, "ms": ms, "bound_ms": bms,
                  "bound_by": by})
            parts["ms"] += calls * ms
            parts["bound_ms"] += calls * bms
        emit({"phase": "conv3_backward_library", "per_step": parts})
    return totals


# ---------------------------------------------------------------------------
# phase 3: train
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str = "") -> dict:
    """Every tensor of a nested dict (None leaves skipped), by a path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def state_tensors(st) -> dict:
    """Every tensor of a train state (CycleGAN, VQGAN, CUT or DCLGAN), by a
    path name."""
    out = _flatten({"g_params": st.g_params, "d_params": st.d_params,
                    "ema": st.ema, "g_mu": st.g_opt.mu, "g_nu": st.g_opt.nu,
                    "d_mu": st.d_opt.mu, "d_nu": st.d_opt.nu})
    for name in ("pool_a", "pool_b"):
        if hasattr(st, name):
            out[name] = getattr(st, name).buffer
    return out


def state_counts(st) -> tuple:
    pools = tuple(getattr(st, n).count for n in ("pool_a", "pool_b")
                  if hasattr(st, n))
    return (st.step, st.g_opt.count, st.d_opt.count, *pools)


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper takes its plain PyTorch version, on the card
    too: the control run of ``compare_card_cpu`` (the same cuDNN convs, no
    hand-written kernel)."""
    import importlib

    mods = [importlib.import_module(f"uig_torch.kernels.{m}")
            for m in ("attention", "augment", "conv", "conv_s2", "convin",
                      "norm")]
    saved = [m.on_cpu for m in mods]
    for m in mods:
        m.on_cpu = lambda name, *tensors: True
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.on_cpu = f


def _nudge(tree: dict, gen) -> None:
    import torch

    for k, t in tree.items():
        if isinstance(t, dict):
            _nudge(t, gen)
        else:
            up = torch.rand(t.shape, generator=gen) < 0.5
            tree[k] = torch.nextafter(t, torch.where(
                up, torch.tensor(float("inf")), torch.tensor(float("-inf"))))


def nudged(state, seed: int):
    """A copy of ``state`` with every G and D parameter moved one fp32 ulp
    up or down, by a seeded coin per element: the least change of the
    step's inputs that fp32 can make."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    s = state.clone()
    _nudge(s.g_params, gen)
    _nudge(s.d_params, gen)
    return s


def _tree_to_cpu(tree):
    if not isinstance(tree, dict):
        return None if tree is None else tree.cpu()
    return {k: _tree_to_cpu(v) for k, v in tree.items()}


def flat_grads(grads: dict) -> dict:
    return {k: t.cpu() for k, t in _flatten(grads).items()}


def grad_gap(x: dict, y: dict, net: str, scale: float) -> tuple:
    """(max |x - y| over net's leaves / scale, the three worst leaves)."""
    errs = sorted((((x[k] - y[k]).abs().max().item() / scale, k)
                   for k in y if k.startswith(net + "/")), reverse=True)
    return errs[0][0], [[k, e] for e, k in errs[:3]]


def _rel(u, v) -> float:
    return abs(float(u) - float(v)) / max(abs(float(v)), 1e-30)


def compare_card_cpu(trainer_cls, cfg, a, b, loss_keys, phase,
                     grad_metrics=()) -> dict:
    """One step at batch 1, full width, from one state and one set of draws,
    taken four ways: on the card with the kernels (A); on the card with the
    plain versions, through the same cuDNN convs (B); on the CPU with the
    plain versions (C); and on the card with the kernels from the state
    with every parameter nudged by one ulp (P).

    A against B isolates the kernels, B against C the library convs, and A
    against P measures how far the step's gradients move when its inputs
    move by rounding alone: a ReLU or LeakyReLU pre-activation within
    rounding of 0 takes either side, and the upstream gradients move with
    it. Gates: losses within 1e-4 relative (A, C); gradients, per network
    relative to its largest CPU gradient, A against C within GRAD_GAP, and
    A against B (what the kernels change) within GRAD_GAP_OVER_FLOOR times
    A against P. ``grad_metrics`` are metrics made from gradients (the
    VQGAN adaptive weight, and the loss it scales): gated as gradients are,
    relative to their own value, with a floor of 1e-4 under the nudge. The
    update is checked on its own, with no element excluded: Adam and the
    EMA on the card from A's gradients against the CPU's Adam and EMA from
    the same gradients, within 1e-5."""
    import torch

    from uig_torch import kernels as K
    from uig_torch.config import apply_overrides

    cfg1 = apply_overrides(cfg, ["data.batch_size=1"])
    card, cpu = trainer_cls(cfg1), trainer_cls(cfg1, device="cpu")
    s0 = cpu.init_state(SEED + 5)
    batch = (a[:1], b[:1])
    draws = cpu.draw(s0, 1, a.shape[1], a.shape[2])
    out = {}

    t0 = time.perf_counter()
    s_a = s0.to(card.device)
    ga, ma = card._grads(s_a, batch, draws)
    card._update(s_a, ga)
    torch.cuda.synchronize()
    out["card_step_s"] = time.perf_counter() - t0
    with plain_versions():
        K.reset_launch_counts()
        gb, mb = card._grads(s0.to(card.device), batch, draws)
        if any(K.launch_counts().values()):
            raise AssertionError(f"plain run launched {K.launch_counts()}")
    gp, mp = card._grads(nudged(s0, SEED + 6).to(card.device), batch, draws)
    t1 = time.perf_counter()
    gc, mc = cpu._grads(s0.clone(), batch, draws)
    out["cpu_grads_s"] = time.perf_counter() - t1

    out["loss_rel_err"] = {k: _rel(ma[k], mc[k]) for k in loss_keys}
    out["loss_rel_err_A_B"] = {k: _rel(ma[k], mb[k]) for k in loss_keys}
    out["loss_rel_err_A_P"] = {k: _rel(ma[k], mp[k]) for k in loss_keys}
    fa, fb, fc, fp = (flat_grads(g) for g in (ga, gb, gc, gp))
    for net in ("g", "d"):
        scale = max(t.abs().max().item() for k, t in fc.items()
                    if k.startswith(net + "/"))
        for pair, (x, y) in {"A_C": (fa, fc), "A_B": (fa, fb),
                             "B_C": (fb, fc), "A_P": (fa, fp)}.items():
            err, worst = grad_gap(x, y, net, scale)
            out[f"{net}_grad_{pair}"] = err
            out[f"{net}_grad_{pair}_worst"] = worst

    s_chk = s0.clone()
    cpu._update(s_chk, _tree_to_cpu(ga))
    ta, tc = state_tensors(s_a), state_tensors(s_chk)
    out["update_max_abs_err"] = max((ta[k].cpu() - tc[k]).abs().max().item()
                                    for k in tc if not k.startswith("pool"))
    out["update_elements"] = sum(t.numel() for k, t in tc.items()
                                 if not k.startswith("pool"))
    emit({"phase": phase, **out})

    bad = {}
    for k in loss_keys:
        ac = out["loss_rel_err"][k]
        if k not in grad_metrics:
            if ac > 1e-4:
                bad[k] = ac
            continue
        ab, ap = out["loss_rel_err_A_B"][k], out["loss_rel_err_A_P"][k]
        if ac > GRAD_GAP or ab > max(GRAD_GAP_OVER_FLOOR * ap, 1e-4):
            bad[k] = (ac, ab, ap)
    for net in ("g", "d"):
        gap, kern = out[f"{net}_grad_A_C"], out[f"{net}_grad_A_B"]
        floor = out[f"{net}_grad_A_P"]
        if gap > GRAD_GAP or kern > GRAD_GAP_OVER_FLOOR * floor:
            bad[f"{net}_grad"] = (gap, kern, floor)
    if out["update_max_abs_err"] > 1e-5:
        bad["update_max_abs_err"] = out["update_max_abs_err"]
    if bad:
        raise AssertionError(f"{phase}: card vs CPU at batch 1: {bad}")
    return out


def _norm_gap(x: dict, y: dict, net: str, scale: float) -> float:
    """||x - y|| over net's leaves / scale (Euclidean, all leaves)."""
    return float(sum(((x[k].double() - y[k].double()) ** 2).sum().item()
                     for k in y if k.startswith(net + "/")) ** 0.5 / scale)


def compare_card_cpu_bf16(trainer_cls, cfg, a, b, loss_keys, phase,
                          grad_metrics=()) -> dict:
    """The bf16 step at batch 1, full width, from one state and one set of
    draws, four ways: A16 on the card with the kernels; B16 on the card with
    the plain versions, through the same cuDNN convs; C16 on the CPU with
    the plain versions; A32 the card's fp32 step with the kernels, from the
    same parameters. A16 against A32 is what bf16 itself moves; the gates
    hold the kernels (A16-B16) within it and the CPU (A16-C16) within twice
    it, per network, for the gradients in the Euclidean norm relative to
    the CPU's (bf16 rounds many ReLU and LeakyReLU pre-activations to
    exactly 0, so a largest-element gap reads the kinks; it is printed
    too). Each loss is one scalar, whose bf16 and fp32 values can agree
    by chance: B16 and C16 are held to A16 within LOSS_RTOL_BF16 of its
    value, and A32's gap is printed. ``grad_metrics`` are metrics made from
    gradients (the VQGAN adaptive weight, a ratio of two gradient norms at
    the last kernel, and the loss it scales): B16 within the larger of
    A32's relative gap and twice the A16-A32 gap of the last kernel's
    gradient (| |a| - |b| | <= |a - b| for each norm), C16 within twice
    that, with LOSS_RTOL_BF16 as the floor. Each gate must be able to fail:
    a zero gradient (1.0 of the norm) and a doubled gradient metric (1.0
    relative) lie over its limits, or the check fails. Where the generator
    has a quantizer (the VQGAN), B16, C16 and A32 take A16's codes (``pin_codes``): latents
    within rounding of two codewords take either code in any two runs, and
    such a flip moves the gradients as far as bf16 does; each run's own
    codes must agree with A16's outside that margin (``_code_agreement``).
    The update is checked as in fp32: Adam and the EMA on the card from
    A16's gradients against the CPU's from the same gradients, within
    1e-5."""
    import torch

    from uig_torch import kernels as K
    from uig_torch.config import apply_overrides

    cfg1 = apply_overrides(cfg, ["data.batch_size=1"])
    cfg1_32 = apply_overrides(cfg1, ["model.compute_dtype=float32"])
    card, cpu = trainer_cls(cfg1), trainer_cls(cfg1, device="cpu")
    card32 = trainer_cls(cfg1_32)
    s0 = cpu.init_state(SEED + 5)
    # the same parameters (init draws from the seed); fp32 pools
    s0_32 = trainer_cls(cfg1_32, device="cpu").init_state(SEED + 5)
    batch = (a[:1], b[:1])
    draws = cpu.draw(s0, 1, a.shape[1], a.shape[2])
    out = {}

    seen, hooks, run = {}, [], [None]
    pin = hasattr(card.generator, "quantizer")
    if pin:
        from torch.func import functional_call

        from uig_torch.models.vqgan import pin_codes
        for tr in (card, cpu, card32):
            hooks.append(tr.generator.quantizer.register_forward_hook(
                lambda m, i, o: seen.__setitem__(run[0], (
                    i[0].detach().float().cpu(), o.codes.cpu()))))

    def pinned(tr, name):
        run[0] = name
        if not pin:
            return contextlib.nullcontext()
        return pin_codes(tr.generator.quantizer, seen["A16"][1])

    try:
        s_a = s0.to(card.device)
        run[0] = "A16"
        ga, ma = card._grads(s_a, batch, draws)
        card._update(s_a, ga)
        with plain_versions(), pinned(card, "B16"):
            K.reset_launch_counts()
            gb, mb = card._grads(s0.to(card.device), batch, draws)
            if any(K.launch_counts().values()):
                raise AssertionError(f"plain run launched "
                                     f"{K.launch_counts()}")
        with pinned(card32, "A32"):
            g32, m32 = card32._grads(s0_32.to(card32.device), batch, draws)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with pinned(cpu, "C16"):
            gc, mc = cpu._grads(s0.clone(), batch, draws)
        out["cpu_grads_s"] = time.perf_counter() - t1
    finally:
        for h in hooks:
            h.remove()
    bad = {}
    if pin:
        cb = s0.g_params["quantizer.codebook"]
        z_a, codes_a = seen["A16"]
        for name in ("B16", "C16", "A32"):
            z = seen[name][0]
            own = functional_call(cpu.generator.quantizer, {"codebook": cb},
                                  (z,)).codes
            agree = _code_agreement(z_a, z, codes_a, own, cb)
            out[f"codes_A16_{name}"] = agree
            if agree["differ_checked"]:
                bad[f"codes_A16_{name}"] = agree

    runs = {"B16": mb, "C16": mc, "A32": m32}
    for pair, m in runs.items():
        out[f"loss_rel_err_A16_{pair}"] = {k: _rel(ma[k], m[k])
                                           for k in loss_keys}
    fa, fb, fc, f32 = (flat_grads(g) for g in (ga, gb, gc, g32))
    for net in ("g", "d"):
        leaves = {k: t for k, t in fc.items() if k.startswith(net + "/")}
        norm = sum((t.double() ** 2).sum().item()
                   for t in leaves.values()) ** 0.5
        top = max(t.abs().max().item() for t in leaves.values())
        gaps = {}
        for pair, y in (("A16_B16", fb), ("A16_C16", fc), ("A16_A32", f32),
                        ("B16_C16", fc)):
            x = fb if pair == "B16_C16" else fa
            gaps[pair] = _norm_gap(x, y, net, norm)
            out[f"{net}_grad_{pair}_max"] = grad_gap(x, y, net, top)[0]
        out[f"{net}_grad_norm_gap"] = gaps
        floor = gaps["A16_A32"]
        # a zero gradient reads 1.0 on both: the gate must refuse it
        if gaps["A16_B16"] > floor or gaps["A16_C16"] > 2 * floor \
                or 2 * floor >= 1.0:
            bad[f"{net}_grad"] = gaps
    if grad_metrics:
        w = f"g/{card.last_kernel}"
        out["last_kernel_grad_gap_A16_A32"] = float(
            (fa[w].double() - f32[w].double()).norm() / f32[w].double().norm())
    for k in loss_keys:
        ab, ac, a32 = (out[f"loss_rel_err_A16_{p}"][k]
                       for p in ("B16", "C16", "A32"))
        if k in grad_metrics:
            lim = max(a32, 2 * out["last_kernel_grad_gap_A16_A32"],
                      LOSS_RTOL_BF16)
            # doubled, a metric reads 1.0 relative: the gate must refuse it
            if ab > lim or ac > 2 * lim or 2 * lim >= 1.0:
                bad[k] = (ab, ac, lim)
        elif max(ab, ac) > LOSS_RTOL_BF16:
            bad[k] = (ab, ac)

    s_chk = s0.clone()
    cpu._update(s_chk, _tree_to_cpu(ga))
    ta, tc = state_tensors(s_a), state_tensors(s_chk)
    out["update_max_abs_err"] = max((ta[k].cpu() - tc[k]).abs().max().item()
                                    for k in tc if not k.startswith("pool"))
    if out["update_max_abs_err"] > 1e-5:
        bad["update_max_abs_err"] = out["update_max_abs_err"]
    emit({"phase": phase, **out})
    if bad:
        raise AssertionError(f"{phase}: bf16 card vs CPU at batch 1: {bad}")
    return out


def phase_train(dev, overrides=TRAIN_OVERRIDES, phase: str = "train",
                steps: int = 20) -> dict:
    """The CycleGAN training step of ``PRESET`` with ``overrides``: the
    main path's launches, 3 steps twice byte-identical, the batch-1
    card-vs-CPU check of its dtype, ``steps`` steps finite with a falling
    cycle loss and timed, and a profiled step. Returns the step's launches
    and the design each kernel of DESIGNS ran (``designs_run``)."""
    import torch

    from uig_torch import kernels as K
    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.train import CycleGANTrainer

    cfg = apply_overrides(get_preset(PRESET), overrides)
    load = cfg.data.load_size
    rng = np.random.default_rng(SEED + 3)
    a, b = (rng.integers(0, 256, (BATCH, load, load, 3), dtype=np.uint8)
            for _ in range(2))
    tr = CycleGANTrainer(cfg)
    state0 = tr.init_state(SEED)
    out = {"phase": phase, "preset": PRESET, "overrides": overrides,
           "compute_dtype": cfg.model.compute_dtype, "batch": BATCH,
           "image": cfg.model.image_size}
    loss_keys = ("g_loss", "d_loss", "g_adv", "g_cycle", "g_idt", "g_lpips",
                 "d_a", "d_b")
    torch.use_deterministic_algorithms(True)
    try:
        # the main path's run: one step, with every count at 0 before it
        run_a = state0.clone()
        K.reset_launch_counts()
        run_a, m = tr.train_step(run_a, (a, b))
        torch.cuda.synchronize()
        launches = K.launch_counts()
        if launches != PER_STEP:
            raise AssertionError(f"launches per step {launches} != {PER_STEP}")
        out["launches_per_step"] = launches
        for _ in range(2):
            run_a, _ = tr.train_step(run_a, (a, b))
        run_b = state0.clone()
        for _ in range(3):
            run_b, _ = tr.train_step(run_b, (a, b))
        ta, tb = state_tensors(run_a), state_tensors(run_b)
        differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
        counts = [state_counts(r) for r in (run_a, run_b)]
        if differ or counts[0] != counts[1]:
            raise AssertionError(f"two 3-step runs differ in {differ[:5]}")
        out["byte_identical_3_steps"] = True
        out["state_tensors_compared"] = len(ta)
        out["pool_dtype"] = str(run_a.pool_a.buffer.dtype)
        del run_a, run_b, ta, tb

        if cfg.model.compute_dtype == "float32":
            compare_card_cpu(CycleGANTrainer, cfg, a, b, loss_keys,
                             "card_vs_cpu_batch1")
        else:
            compare_card_cpu_bf16(CycleGANTrainer, cfg, a, b, loss_keys,
                                  f"{phase}_card_vs_cpu_batch1")

        if tr.perceptual_fn is not None:
            emit(lpips_parts(tr, state0, a, b, phase))

        # steps on the fixed batch: finite, falling cycle loss, timing
        st = state0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, hist = [], []
        for _ in range(steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            st, m = tr.train_step(st, (a, b))
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
            hist.append({k: float(v) for k, v in m.items()})
        bad = [h for h in hist if not all(np.isfinite(v) for v in h.values())]
        if bad:
            raise AssertionError(f"non-finite losses: {bad[0]}")
        cyc = [h["g_cycle"] for h in hist]
        if not np.mean(cyc[-5:]) < np.mean(cyc[:5]):
            raise AssertionError(f"g_cycle does not fall: {cyc}")
        timed = times[5:]
        step_ms = float(np.median(timed))
        out.update(
            steps=len(hist), g_cycle_first=cyc[0], g_cycle_last=cyc[-1],
            g_loss_first=hist[0]["g_loss"], g_loss_last=hist[-1]["g_loss"],
            d_loss_first=hist[0]["d_loss"], d_loss_last=hist[-1]["d_loss"],
            step_ms_median=step_ms, step_ms_timed=len(timed),
            step_ms_min=float(np.min(timed)),
            step_ms_max=float(np.max(timed)),
            img_per_s=1e3 * BATCH / step_ms,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            nvidia_smi=nvidia_smi())
        emit(out)
        prof = profile_call(lambda: tr.train_step(st, (a, b)),
                            f"{phase}_profile", calls=True)
        calls = prof.pop("calls")
        prof["designs"] = designs_run(calls, phase,
                                      expect=STEP_DESIGNS[
                                          cfg.model.compute_dtype])
        prof["design_calls"] = design_calls(calls)
        emit(prof)
    finally:
        torch.use_deterministic_algorithms(False)
    return launches, prof["designs"], step_ms


def lpips_parts(tr, state0, a, b, phase: str) -> dict:
    """The LPIPS share of the step of ``tr``: the same step with
    ``loss.lambda_lpips=0`` (median of LPIPS_OFF_STEPS CUDA-event-timed
    steps after 2, from a copy of ``state0``), and the term alone, two LPIPS
    distances at the step's batch and their gradients with respect to the
    reconstructions, timed and profiled."""
    import torch

    from uig_torch.config import apply_overrides
    from uig_torch.serving import exact_fp32
    from uig_torch.train import CycleGANTrainer

    off = CycleGANTrainer(apply_overrides(tr.cfg, ["loss.lambda_lpips=0"]))
    st = state0.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(LPIPS_OFF_STEPS + 2):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        st, _ = off.train_step(st, (a, b))
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    off_ms = float(np.median(times[2:]))
    out = {"phase": f"{phase}_lpips", "lpips_off_step_ms_median": off_ms,
           "lpips_off_step_ms_min": float(np.min(times[2:])),
           "lpips_off_step_ms_max": float(np.max(times[2:])),
           "lpips_off_img_per_s": 1e3 * BATCH / off_ms,
           "lpips_off_peak_mem_gib":
               torch.cuda.max_memory_allocated() / 2**30}
    del st, off
    lp = tr.perceptual_fn
    hw, dt = tr.cfg.model.image_size, tr.dtype
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    real, rec = ((torch.rand(2, BATCH, hw, hw, 3, generator=g) * 2 - 1).to(
        tr.device, dt) for _ in range(2))
    rec.requires_grad_(True)

    def term():  # under the step's precision: fp32 convs without TF32
        with exact_fp32():
            return torch.autograd.grad(
                lp(real[0], rec[0]) + lp(real[1], rec[1]), rec)

    out["lpips_term_ms"] = cuda_ms(term, iters=3, warmup=1)
    prof = profile_call(term, f"{phase}_lpips_term_profile")
    out["lpips_term_device_ms"] = prof["device_busy_ms"]
    out["lpips_term_device_kernels"] = prof["device_kernels"]
    out["lpips_term_top"] = prof["top"][:5]
    return out


# ---------------------------------------------------------------------------
# phase cut: CUT, FastCUT and DCLGAN as published, bf16, batch 16
# ---------------------------------------------------------------------------

# (preset, overrides, phase name): fastcut256 as published, and the CUT
# recipe of cut256_multihost in one process (its multi-process run waits
# for ROADMAP item 12), then dclgan256 as published. bf16, 256², batch 16,
# augment=pallas, taps (0, 4, 8, 12, 16), 256 patches a tap, as published.
CUT_CASES = (("fastcut256", [], "cut_fastcut256"),
             ("cut256_multihost", ["parallel.multihost=false"],
              "cut_cut256"),
             ("dclgan256", [], "cut_dclgan256"))
CUT_STEPS = 20
CUT_EVAL_SAMPLES = 32  # eval-fid on the CUT run's checkpoint, a side


def contrastive_per_step(kind: str, identity: bool) -> dict:
    """Launches in one step of a contrastive trainer at the presets' nine
    blocks and taps (0, 4, 8, 12, 16), unfused applies (the presets'): a
    full generator apply launches 5 norms (d128's, a tap, with its ReLU
    apart), 18 conv3+IN, both downsamples and the head; an encoder pass
    stops at layer 16 (3 norms, 8 blocks' 16 conv3+IN, both downsamples);
    a discriminator apply 3 norms. CUT: the translation and its query pass,
    with the identity term the same again, and D once in the G loss and
    twice in the D loss. DCLGAN: two translations, two identities, two
    query passes through the other generator, and D_a and D_b once in the
    G loss and twice each in the D loss. Every norm, conv3+IN, downsample
    and head is differentiated, and each conv3+IN backward runs the norm
    backward once."""
    if kind == "dclgan":
        full, enc, d = 4, 2, 6
    else:
        full = enc = 2 if identity else 1
        d = 3
    k2f = 5 * full + 3 * enc + 3 * d
    k3 = 18 * full + 16 * enc
    s2 = 2 * (full + enc)
    return {k: 0 for k in PER_STEP} | {
        "augment_batch": 2, "instance_norm": k2f,
        "instance_norm_bwd": k2f + k3, "conv3_in_act": k3, "conv7": full,
        "conv7_dgrad": full, "conv7_wgrad": full, "conv3s2": s2,
        "conv3s2_dgrad": s2, "conv3s2_wgrad": s2}


def compare_kernels_plain(tr, cfg, state0, a, b, loss_keys,
                          phase: str) -> dict:
    """The bf16 step's gradients at the step's own batch (16 for the
    contrastive trainers as published), from ``state0`` and one set of
    draws, three ways on the card: A16 with the kernels; B16 with the plain
    versions, which must launch no kernel; A32 the fp32 step with the
    kernels from the same parameters, what bf16 itself moves. As
    ``compare_card_cpu_bf16`` holds them at batch 1: per network, the
    kernels' gap A16-B16 (Euclidean, relative to B16's norm) within the
    A16-A32 gap, which must lie under 0.5 (a zero gradient reads 1.0, so
    the gate can fail); B16's losses within LOSS_RTOL_BF16 of A16's."""
    import torch

    from uig_torch import kernels as K
    from uig_torch.config import apply_overrides

    batch = (a, b)
    draws = tr.draw(state0, a.shape[0], a.shape[1], a.shape[2])
    tr32 = type(tr)(apply_overrides(cfg, ["model.compute_dtype=float32"]))
    s32 = tr32.init_state(SEED)
    p16, p32 = _flatten(state0.g_params), _flatten(s32.g_params)
    if p16.keys() != p32.keys() or not all(
            torch.equal(p16[k], p32[k]) for k in p16):
        raise AssertionError(f"{phase}: the fp32 trainer's parameters differ")
    K.reset_launch_counts()
    ga, ma = tr._grads(state0.clone(), batch, draws)
    launched = K.launch_counts()
    with plain_versions():
        K.reset_launch_counts()
        gb, mb = tr._grads(state0.clone(), batch, draws)
        if any(K.launch_counts().values()):
            raise AssertionError(f"{phase}: plain run launched "
                                 f"{K.launch_counts()}")
    g32, m32 = tr32._grads(s32, batch, draws)
    torch.cuda.synchronize()
    del tr32, s32
    out = {"batch": int(a.shape[0]), "kernel_launches": launched,
           "loss_rel_err_A16_B16": {k: _rel(ma[k], mb[k]) for k in loss_keys},
           "loss_rel_err_A16_A32": {k: _rel(ma[k], m32[k])
                                    for k in loss_keys}}
    fa, fb, f32 = (flat_grads(g) for g in (ga, gb, g32))
    bad = {k: v for k, v in out["loss_rel_err_A16_B16"].items()
           if v > LOSS_RTOL_BF16}
    for net in ("g", "d"):
        norm = sum((t.double() ** 2).sum().item() for k, t in fb.items()
                   if k.startswith(net + "/")) ** 0.5
        gaps = {"A16_B16": _norm_gap(fa, fb, net, norm),
                "A16_A32": _norm_gap(fa, f32, net, norm)}
        out[f"{net}_grad_norm_gap"] = gaps
        if gaps["A16_B16"] > gaps["A16_A32"] or gaps["A16_A32"] >= 0.5:
            bad[f"{net}_grad"] = gaps
    emit({"phase": phase, **out})
    if bad:
        raise AssertionError(f"{phase}: kernels vs plain versions at batch "
                             f"{out['batch']}: {bad}")
    return out


def phase_contrastive(preset: str, overrides: list, phase: str) -> tuple:
    """One contrastive trainer as published (bf16, 256², batch 16): one
    step's launches per kernel (``contrastive_per_step``); 3 steps twice
    from one state, byte-identical; the step's gradients at batch 16 with
    the kernels against the plain versions (``compare_kernels_plain``); the
    batch-1 step on the card against the CPU (``compare_card_cpu_bf16``);
    CUT_STEPS steps finite and timed (CUDA events; the median of the last
    CUT_STEPS - 5), peak memory; one
    profiled step, its designs held to STEP_DESIGNS["bfloat16"]. Returns
    (launches, the trainer, the state after the timed steps, config)."""
    import torch

    from uig_torch import kernels as K
    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.train.loop import build_trainer

    t_phase = time.perf_counter()
    cfg = apply_overrides(get_preset(preset), overrides)
    m = cfg.model
    if (m.compute_dtype, m.image_size, cfg.data.batch_size,
            cfg.data.augment) != ("bfloat16", 256, 16, "pallas"):
        raise AssertionError(f"{phase}: {preset} is not as published")
    kind = "dclgan" if m.kind == "dclgan" else "cut"
    load, batch = cfg.data.load_size, cfg.data.batch_size
    rng = np.random.default_rng(SEED + 11)
    a, b = (rng.integers(0, 256, (batch, load, load, 3), dtype=np.uint8)
            for _ in range(2))
    tr = build_trainer(cfg, "cuda")
    state0 = tr.init_state(SEED)
    want = contrastive_per_step(kind, cfg.loss.nce_include_identity)
    out = {"phase": phase, "preset": preset, "overrides": overrides,
           "compute_dtype": m.compute_dtype, "batch": batch,
           "image": m.image_size, "taps": list(tr.taps),
           "patches": m.nce_patches,
           "flip_equivariance": cfg.loss.nce_flip_equivariance,
           "nce_identity": cfg.loss.nce_include_identity}
    loss_keys = (("g_loss", "d_loss", "g_adv", "nce_a", "nce_b", "g_idt",
                  "d_a", "d_b") if kind == "dclgan" else
                 ("g_loss", "d_loss", "g_adv", "nce", "nce_idt"))
    torch.use_deterministic_algorithms(True)
    try:
        run_a = state0.clone()
        K.reset_launch_counts()
        run_a, _ = tr.train_step(run_a, (a, b))
        torch.cuda.synchronize()
        launches = K.launch_counts()
        if launches != want:
            raise AssertionError(f"{phase}: launches per step {launches} "
                                 f"!= {want}")
        out["launches_per_step"] = launches
        for _ in range(2):
            run_a, _ = tr.train_step(run_a, (a, b))
        run_b = state0.clone()
        for _ in range(3):
            run_b, _ = tr.train_step(run_b, (a, b))
        ta, tb = state_tensors(run_a), state_tensors(run_b)
        differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
        counts = [state_counts(r) for r in (run_a, run_b)]
        if differ or counts[0] != counts[1]:
            raise AssertionError(f"{phase}: two 3-step runs differ in "
                                 f"{differ[:5]}")
        out["byte_identical_3_steps"] = True
        out["state_tensors_compared"] = len(ta)
        del run_a, run_b, ta, tb
        torch.cuda.empty_cache()

        compare_kernels_plain(tr, cfg, state0, a, b, loss_keys,
                              f"{phase}_kernels_vs_plain_batch{batch}")
        torch.cuda.empty_cache()

        cmp = compare_card_cpu_bf16(type(tr), cfg, a, b, loss_keys,
                                    f"{phase}_card_vs_cpu_batch1")
        out["card_vs_cpu_cpu_s"] = cmp["cpu_grads_s"]

        st = state0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, hist = [], []
        for _ in range(CUT_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            st, mets = tr.train_step(st, (a, b))
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
            hist.append({k: float(v) for k, v in mets.items()})
        bad = [h for h in hist if not all(np.isfinite(v) for v in h.values())]
        if bad:
            raise AssertionError(f"{phase}: non-finite metrics {bad[0]}")
        timed = times[5:]
        step_ms = float(np.median(timed))
        out.update(
            steps=len(hist), first=hist[0], last=hist[-1],
            step_ms_median=step_ms, step_ms_timed=len(timed),
            step_ms_min=float(np.min(timed)),
            step_ms_max=float(np.max(timed)),
            img_per_s=1e3 * batch / step_ms,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            nvidia_smi=nvidia_smi())
        prof = profile_call(lambda: tr.train_step(st, (a, b)),
                            f"{phase}_profile", calls=True)
        calls = prof.pop("calls")
        prof["designs"] = designs_run(calls, phase, per_step=want,
                                      expect=STEP_DESIGNS["bfloat16"])
        out["profile"] = prof
        out["elapsed_s"] = time.perf_counter() - t_phase
        emit(out)
    finally:
        torch.use_deterministic_algorithms(False)
    return launches, tr, st, cfg


def _cut_run_commands(tr, state, cfg, work: str) -> dict:
    """``translate --run-dir`` and ``eval-fid`` on a checkpoint of the CUT
    run (a run directory written as ``fit`` writes it): the PNGs equal the
    EMA's translate of the same images, b2a raises JAX's ValueError, and
    eval-fid (random-conv features, CUT_EVAL_SAMPLES a side) gives the same
    FID twice."""
    import torch
    from PIL import Image

    from uig_torch.checkpoint import CheckpointManager, dump_run_config
    from uig_torch.cli.eval_fid import run_eval_fid
    from uig_torch.cli.translate import run_translate
    from uig_torch.config import apply_overrides, config_to_dict
    from uig_torch.kernels.augment import (center_crop_normalize,
                                           denormalize_to_u8)

    run = os.path.join(work, "cut_run")
    cfg = apply_overrides(cfg, ["eval.fid_features=random"])
    dump_run_config(config_to_dict(cfg), run)
    mgr = CheckpointManager(os.path.join(run, "ckpt"))
    mgr.save(int(state.step), state)
    mgr.close()
    load = cfg.data.load_size
    imgs = np.random.default_rng(SEED + 12).integers(
        0, 256, (FIT_IMAGES, load, load, 3), dtype=np.uint8)
    src, dst = os.path.join(work, "cut_in"), os.path.join(work, "cut_out")
    os.makedirs(src)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(os.path.join(src, f"im{i}.png"))
    t0 = time.perf_counter()
    n = run_translate(None, None, src, dst, run_dir=run, batch_size=4)
    secs = time.perf_counter() - t0
    got = np.stack([np.asarray(Image.open(os.path.join(dst, f"im{i}.png")))
                    for i in range(FIT_IMAGES)])
    with torch.inference_mode():
        want = denormalize_to_u8(tr.translate(state.ema, center_crop_normalize(
            torch.from_numpy(imgs).to(tr.device), cfg.model.image_size),
            "a2b")).cpu().numpy()
    if n != FIT_IMAGES or not np.array_equal(got, want):
        raise AssertionError("cut: translate --run-dir differs from the "
                             "EMA's translate")
    try:
        run_translate(None, None, src, dst + "_b2a", run_dir=run,
                      direction="b2a")
        raise AssertionError("cut: translate --run-dir b2a did not raise")
    except ValueError as e:
        refusal = str(e)
    t0 = time.perf_counter()
    fid = run_eval_fid(run, num_samples=CUT_EVAL_SAMPLES, batch_size=16)
    fid_s = time.perf_counter() - t0
    again = run_eval_fid(run, num_samples=CUT_EVAL_SAMPLES, batch_size=16)
    if fid != again or not np.isfinite(fid):
        raise AssertionError(f"cut: eval-fid {fid} then {again}")
    return {"translate_run_dir_png_equal": True, "translate_images": n,
            "translate_s": secs, "b2a_refused": refusal,
            "eval_fid_random": fid, "eval_fid_repeat_bit_equal": True,
            "eval_fid_s": fid_s, "eval_fid_samples": CUT_EVAL_SAMPLES}


def phase_cut(work: str) -> dict:
    """Phase cut: ``phase_contrastive`` for each of CUT_CASES, then the
    CUT run's commands (``_cut_run_commands``). Returns {phase name: one
    step's launches}."""
    import torch

    t_phase = time.perf_counter()
    launches = {}
    for preset, overrides, name in CUT_CASES:
        launches[name], tr, st, cfg = phase_contrastive(preset, overrides,
                                                        name)
        if preset == "cut256_multihost":
            emit({"phase": "cut_commands", "preset": preset,
                  **_cut_run_commands(tr, st, cfg, work)})
        del tr, st
        torch.cuda.empty_cache()
    # the norm forward's counters (an exit count, then a count and a flag
    # an image) are back at 0 after every plan of the phase: each launch's
    # last block reset them
    from uig_torch.kernels import norm
    torch.cuda.synchronize()
    left = {str(k): int(v.count_nonzero()) for k, v in norm._SYNC.items()}
    if not left or any(left.values()):
        raise AssertionError(f"cut: the norm forward's counters {left}")
    emit({"phase": "cut", "norm_fwd_counters_nonzero": left,
          "elapsed_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase 8: fit, through the command line
# ---------------------------------------------------------------------------

# python -m uig_torch.cli train --preset cyclegan256_dp as published (bf16,
# LPIPS on); the overrides set the data and the cadences, never a width
FIT_FID_EVERY = 3
FIT_FID_SAMPLES = 16  # one translate apply a FID (eval.fid_batch_size 16)
FIT_OVERRIDES = ["data.source=synthetic", "data.load_size=286",
                 "data.batch_size=8", "run.log_every=2", "run.ckpt_every=3",
                 "eval.sample_grid_every=6",
                 f"eval.fid_every={FIT_FID_EVERY}",
                 f"eval.fid_num_samples={FIT_FID_SAMPLES}"]
FIT_STEPS = 6
FIT_TIMEOUT = 240  # seconds a training process may take
FIT_IMAGES = 4     # images translate --run-dir turns into PNGs
# a training process under launch counting: the counts set to 0 just
# before the command line's main() and written to argv[1] just after
FIT_COUNTED = ("import json, sys\n"
               "from uig_torch import kernels as K\n"
               "from uig_torch.cli.__main__ import main\n"
               "K.reset_launch_counts()\n"
               "rc = main(sys.argv[2:])\n"
               "json.dump(K.launch_counts(), open(sys.argv[1], 'w'))\n"
               "sys.exit(rc)\n")


def _train_cmd(workdir: str, name: str, steps: int, extra=()) -> list:
    args = ["train", "--preset", PRESET, "--max-steps", str(steps)]
    for o in [*FIT_OVERRIDES, f"run.workdir={workdir}", f"run.name={name}",
              *extra]:
        args += ["--set", o]
    return args


def _child_env() -> dict:
    """The environment of a training process: the checkout's sources, and
    no cuBLAS workspace setting (fit has to arrange it itself)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("CUBLAS_WORKSPACE_CONFIG", None)
    return env


def _run_child(cmd: list, what: str) -> tuple:
    """(wall clock at the start, seconds) of a training process that must
    exit 0 and print its final metrics."""
    start, t0 = time.time(), time.perf_counter()
    r = subprocess.run(cmd, env=_child_env(), cwd=ROOT, capture_output=True,
                       text=True, timeout=FIT_TIMEOUT)
    if r.returncode != 0 or '"final_metrics"' not in r.stdout:
        raise AssertionError(f"fit: {what} exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    return start, time.perf_counter() - t0


def _metrics(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _clean_intervals(recs: list, every: tuple) -> list:
    """(ms a step, the later line) between consecutive log lines whose
    steps ran no checkpoint, sample grid or FID: those of the earlier
    line's step come after it, so they fall in its interval. The FID lines
    are not log lines (a FID runs after its step's log line)."""
    out = []
    recs = [r for r in recs if "fid" not in r]
    for r0, r1 in zip(recs, recs[1:]):
        s0, s1 = r0["step"], r1["step"]
        if any(s % e == 0 for s in range(s0, s1) for e in every if e):
            continue
        out.append((1e3 * (r1["time"] - r0["time"]) / (s1 - s0), r1))
    return out


def _sigterm_run(workdir: str) -> dict:
    """A run that gets SIGTERM once its first metrics line is written: it
    must exit 0 with a checkpoint at the step it reached (the only one: no
    cadence saves)."""
    from uig_torch.checkpoint import CheckpointManager

    name = "sigterm"
    run_dir = os.path.join(workdir, name)
    cmd = [sys.executable, "-m", "uig_torch.cli",
           *_train_cmd(workdir, name, 1000,
                       ["run.ckpt_every=0", "eval.sample_grid_every=0"])]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=_child_env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        path = os.path.join(run_dir, "metrics.jsonl")
        while not (os.path.exists(path) and os.path.getsize(path) > 0):
            if proc.poll() is not None or time.perf_counter() - t0 > FIT_TIMEOUT:
                raise AssertionError("fit: the SIGTERM run ended or stalled "
                                     "before its first metrics line")

            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=FIT_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    mgr = CheckpointManager(os.path.join(run_dir, "ckpt"))
    steps = mgr.all_steps()
    meta = mgr.read()[1] if steps else {}
    reached = _metrics(run_dir)[-1]["step"]
    ok = (proc.returncode == 0 and len(steps) == 1 and steps[0] >= reached
          and meta["ints"]["step"] == steps[0]
          and meta["data_state"] == {"t_consumed": steps[0]}
          and '"final_metrics"' in out)
    if not ok:
        raise AssertionError(f"fit: SIGTERM run rc {proc.returncode}, "
                             f"checkpoints {steps}, meta {meta.get('ints')}:"
                             f" {err[-2000:]}")
    return {"rc": proc.returncode, "first_log_step": reached,
            "saved_step": steps[0], "seconds": time.perf_counter() - t0}


def _fids(recs: list) -> dict:
    return {r["step"]: r["fid"] for r in recs if "fid" in r}


def _retention(run_dir: str, saves: list) -> dict:
    """The run's checkpoints against those orbax's best-FID retention keeps
    of ``saves`` ((step, metrics or None) in order, as fit saved them)."""
    from uig_torch.checkpoint import CheckpointManager
    from uig_torch.checkpoint.ckpt import preserved

    mgr = CheckpointManager(os.path.join(run_dir, "ckpt"))
    keep = [s for (s, _), k in zip(saves, preserved(saves, 3, "fid")) if k]
    got = {s: mgr.metrics(s) for s in mgr.all_steps()}
    if sorted(got) != keep or any(got[s] != m for s, m in saves if s in got):
        raise AssertionError(f"fit: {run_dir} keeps {got}, the retention "
                             f"rule {keep} of {saves}")
    return got


def phase_fit(bare_step_ms: float, work: str) -> tuple:
    """``python -m uig_torch.cli train`` for ``PRESET`` as published, with the
    in-training FID every FIT_FID_EVERY steps (random features,
    FIT_FID_SAMPLES images): run A goes FIT_STEPS steps in one process (its
    launches counted), run B half of them, exits, and a second process
    resumes it to FIT_STEPS; the two final checkpoints must hold
    byte-identical tensors and equal counts and cursors, both runs must
    write the same FIDs (the resumed run's first one included) and keep the
    checkpoints of the best-FID retention. ``translate --run-dir`` on run A
    must give the PNGs of a direct ``Translator`` call on the restored EMA.
    A run that gets SIGTERM must save the step it reached. Reports fit's
    step time between clean log lines beside the bare step's
    (``bare_step_ms``, phase 3b), its images/s and input stall, and the
    checkpoint's bytes and save and restore times. The runs live under
    ``work``. Returns run A's launches and its directory."""
    import torch
    from PIL import Image

    from uig_torch.checkpoint import CheckpointManager
    from uig_torch.cli.__main__ import main as cli_main
    from uig_torch.config import apply_overrides, get_preset, load_config
    from uig_torch.data import SyntheticUnpairedDataset
    from uig_torch.serving import Translator
    from uig_torch.train import CycleGANTrainer

    torch.cuda.empty_cache()
    half = FIT_STEPS // 2
    out = {"phase": "fit", "preset": PRESET, "overrides": FIT_OVERRIDES,
           "steps": FIT_STEPS}
    counts = os.path.join(work, "launches.json")
    module = [sys.executable, "-m", "uig_torch.cli"]
    procs = {
        "run_a": _run_child([sys.executable, "-c", FIT_COUNTED, counts,
                             *_train_cmd(work, "a", FIT_STEPS)],
                            "run A"),
        "run_b_first": _run_child(
            module + _train_cmd(work, "b", half), "run B"),
    }
    run_a, run_b = os.path.join(work, "a"), os.path.join(work, "b")
    # run B's first process's lines, before the resumed one appends
    first_b = len(_metrics(run_b))
    procs["run_b_resumed"] = _run_child(
        module + _train_cmd(work, "b", FIT_STEPS), "run B resumed")
    with open(counts) as f:
        launches = json.load(f)
    recs_a, recs_b = _metrics(run_a), _metrics(run_b)
    # seconds from a process's start to its first metrics line (import,
    # CUDA, the trainer and LPIPS built, restore, the first two steps)
    firsts = {"run_a": recs_a[0], "run_b_first": recs_b[0],
              "run_b_resumed": recs_b[first_b]}
    secs = {k: {"seconds": v[1],
                "to_first_log_line": firsts[k]["time"] - v[0]}
            for k, v in procs.items()}
    mgr_a = CheckpointManager(os.path.join(run_a, "ckpt"))
    ta, ma = mgr_a.read()
    tb, mb = CheckpointManager(os.path.join(run_b, "ckpt")).read()
    differ = sorted(k for k in set(ta) | set(tb)
                    if k not in ta or k not in tb
                    or not torch.equal(ta[k], tb[k]))
    if differ or ma["ints"] != mb["ints"] or ma["step"] != FIT_STEPS \
            or ma["data_state"] != mb["data_state"] \
            or ma["data_state"] != {"t_consumed": FIT_STEPS}:
        raise AssertionError(f"fit: resumed run differs in {differ[:5]} "
                             f"({len(differ)}), {ma['ints']} vs "
                             f"{mb['ints']}")
    out.update(resume_byte_identical=True, tensors_compared=len(ta),
               cursor=ma["data_state"], counts=ma["ints"],
               ckpt_steps_a=mgr_a.all_steps())
    del ta, tb
    # the in-training FID: A's and the resumed B's values agree, and the
    # checkpoints kept are the retention rule's (A saves at 3 and 6 with
    # the FID just taken; B at 3, then at 6 after its resume)
    fa, fb = _fids(recs_a), _fids(recs_b)
    want_steps = list(range(FIT_FID_EVERY, FIT_STEPS + 1, FIT_FID_EVERY))
    if sorted(fa) != want_steps or fa != fb \
            or not all(np.isfinite(v) for v in fa.values()):
        raise AssertionError(f"fit: FIDs {fa} (unbroken) vs {fb} "
                             "(resumed)")
    saves = [(s, {"fid": fa[s]}) for s in range(3, FIT_STEPS + 1, 3)]
    kept = {"a": _retention(run_a, saves), "b": _retention(run_b, saves)}
    log6 = [r for r in recs_a if r["step"] == FIT_STEPS and "fid" not in r]
    fid6 = [r for r in recs_a if r["step"] == FIT_STEPS and "fid" in r]
    out.update(fid=fa, fid_resumed_equal=True, ckpt_kept=kept,
               fid_seconds_at_step_6=fid6[0]["time"] - log6[0]["time"])

    # the checkpoint: restore onto the card, save again, its bytes
    cfg = apply_overrides(load_config(os.path.join(run_a, "config.json")),
                          ["loss.lambda_lpips=0"])  # the template's VGG
    tr = CycleGANTrainer(cfg)
    template = tr.init_state(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, data_state, _ = mgr_a.restore(template)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    del template
    t0 = time.perf_counter()
    saved = CheckpointManager(os.path.join(work, "resave")).save(
        FIT_STEPS, state, data_state)
    save_ms = 1e3 * (time.perf_counter() - t0)
    nbytes = sum(os.path.getsize(os.path.join(saved, n))
                 for n in os.listdir(saved))
    out.update(ckpt_bytes=nbytes, ckpt_save_ms=save_ms,
               ckpt_restore_ms=restore_ms)

    # translate --run-dir against a direct Translator call on the EMA
    load = cfg.data.load_size
    src, dst = os.path.join(work, "in"), os.path.join(work, "out")
    os.makedirs(src)
    dom = SyntheticUnpairedDataset(FIT_IMAGES, load, SEED + 5).domain_a
    raw = np.stack([dom[i] for i in range(FIT_IMAGES)])
    for i in range(FIT_IMAGES):
        Image.fromarray(raw[i]).save(os.path.join(src, f"im{i}.png"))
    if cli_main(["translate", "--run-dir", run_a, "--input-dir", src,
                 "--output-dir", dst, "--batch-size", str(FIT_IMAGES)]
                ) != 0:
        raise AssertionError("fit: translate --run-dir failed")
    got = np.stack([np.asarray(Image.open(os.path.join(dst, f"im{i}.png")))
                    for i in range(FIT_IMAGES)])
    direct = Translator(os.path.join(run_a, "config.json"),
                        state.ema["a2b"], batch_size=FIT_IMAGES)(raw)
    if not np.array_equal(got, direct):
        raise AssertionError("fit: translate --run-dir differs from a "
                             "direct Translator call")
    spread = int(got.max()) - int(got.min())
    out.update(translate_run_dir_byte_identical=True,
               translate_images=FIT_IMAGES, translate_spread=spread)
    del state, tr

    out["sigterm"] = _sigterm_run(work)
    # run.ckpt_every, eval.sample_grid_every, eval.fid_every
    every = (3, 6, FIT_FID_EVERY)
    clean = (_clean_intervals(recs_a, every)
             + _clean_intervals(recs_b[first_b:], every))
    recs = recs_a + recs_b
    bad = [r for r in recs if not all(np.isfinite(v) for k, v in r.items()
                                      if isinstance(v, float))]
    if bad or not clean:
        raise AssertionError(f"fit: non-finite metrics {bad[:1]} or no clean "
                             "interval")
    grids = FIT_STEPS // 6  # eval.sample_grid_every: a2b and b2a applies
    fids = FIT_STEPS // FIT_FID_EVERY  # one a2b translate apply each
    want = {k: FIT_STEPS * PER_STEP[k] + (grids * 2 + fids) * PER_APPLY[k]
            for k in PER_STEP}
    if launches != want:
        raise AssertionError(f"fit: run A launched {launches}, want {want}")
    ms = [c[0] for c in clean]
    out.update(
        fit_step_ms_median=float(np.median(ms)), fit_step_ms=ms,
        fit_images_per_sec_chip=[c[1]["images_per_sec_chip"] for c in clean],
        fit_input_stall_pct=[c[1]["input_stall_pct"] for c in clean],
        fit_hbm_gb_peak=max(r.get("hbm_gb_peak", 0.0) for r in recs),
        bare_step_ms_median=bare_step_ms, launches=launches,
        process_seconds=secs, nvidia_smi=nvidia_smi())
    emit(out)
    return launches, run_a


# ---------------------------------------------------------------------------
# phase 9: evaluate the run of phase fit
# ---------------------------------------------------------------------------

EVAL_SAMPLES = 64   # eval images a side for eval-fid (batch 16)
EVAL_BATCH = 16     # eval-fid's --batch-size and the timing batch
INLINE_FID_SAMPLES = 200  # smalldata64's eval.fid_num_samples
# card bf16 against CPU bf16, with bf16's own distance from fp32 (the CPU
# bf16 output against the card's fp32) as the yardstick: at most these
# multiples of it at the largest element and in the mean
BF16_OVER_FLOOR = {"max": 1.5, "mean": 1.25}
EVAL_FEATURE_TOL = 1e-4  # extractor features, card vs CPU, of the largest
VQ_SAMPLES = 4       # vqgan512 sample -n, and eval-fid's batch
VQ_EVAL_SAMPLES = 8


def _bf16_translate(run_a: str) -> dict:
    """fp32 and bf16 translate of run A's EMA at batch BATCH: launches of
    a bf16 apply, byte-identical repeats, generator ms a batch and img/s of
    both, and the card against the CPU in bf16 at batch 1."""
    import torch

    from uig_torch import kernels as K
    from uig_torch.kernels.augment import (center_crop_normalize,
                                           denormalize_to_u8)
    from uig_torch.serving import Translator

    tr = {dt: Translator.from_run_dir(
        run_a, batch_size=BATCH, overrides=[f"model.eval_dtype={dt}"])
        for dt in DTYPE_NAMES}
    tr16 = tr["bfloat16"]
    rng = np.random.default_rng(SEED + 3)
    raw = rng.integers(0, 256, (BATCH, tr16.load, tr16.load, 3),
                       dtype=np.uint8)
    K.reset_launch_counts()
    out1 = tr16(raw)  # the bf16 serving path's run
    launches = K.launch_counts()
    if launches != PER_APPLY:
        raise AssertionError(f"eval: bf16 apply launched {launches}")
    out2 = tr16(raw)
    spread = int(out1.max()) - int(out1.min())
    if not np.array_equal(out1, out2) or spread < 16:
        raise AssertionError(f"eval: bf16 repeats differ or flat ({spread})")
    x = center_crop_normalize(torch.from_numpy(raw).to(tr16.device),
                              tr16.crop)
    res = {"bf16_launches_per_apply": launches, "bf16_byte_identical": True,
           "bf16_spread": spread}
    for dt, t in tr.items():
        ms = cuda_ms(lambda: t.translate_float(x), iters=10, warmup=2)
        res[f"generator_ms_per_batch_{dt}"] = ms
        res[f"generator_img_per_s_{dt}"] = 1e3 * BATCH / ms
    y16 = tr16.translate_float(x[:1]).float().cpu()
    y32 = tr["float32"].translate_float(x[:1]).cpu()
    t0 = time.perf_counter()
    cpu = Translator.from_run_dir(run_a, batch_size=1, device="cpu",
                                  overrides=["model.eval_dtype=bfloat16"])
    c16 = cpu.translate_float(x[:1].cpu()).float()
    d, floor = (y16 - c16).abs(), (c16 - y32).abs()
    gap = {"max": d.max().item(), "mean": d.mean().item(),
           "floor_max": floor.max().item(), "floor_mean": floor.mean().item()}
    if gap["max"] > BF16_OVER_FLOOR["max"] * gap["floor_max"] \
            or gap["mean"] > BF16_OVER_FLOOR["mean"] * gap["floor_mean"]:
        raise AssertionError(f"eval: bf16 card vs CPU {gap}")
    u8 = [denormalize_to_u8(y).to(torch.int16) for y in (y16, c16)]
    res.update(bf16_card_vs_cpu=gap,
               bf16_card_vs_cpu_u8_max=int((u8[0] - u8[1]).abs().max()),
               bf16_cpu_seconds=time.perf_counter() - t0,
               bf16_tolerance=BF16_OVER_FLOOR)
    return res


def _features_and_rates(run_a: str) -> dict:
    """Each extractor on the card against the CPU at batch 2 (two 256²
    eval images; the InceptionV3 resizes them to 299²), and img/s of
    translate and of each extractor at batch EVAL_BATCH."""
    import torch

    from uig_torch.cli.translate import load_run
    from uig_torch.config import apply_overrides
    from uig_torch.data import eval_datasets
    from uig_torch.eval.fid import make_feature_fn
    from uig_torch.kernels.augment import center_crop_normalize

    cfg, trainer, state = load_run(run_a, overrides=["loss.lambda_lpips=0"])
    ds_a, _ = eval_datasets(cfg)
    raw = torch.from_numpy(np.stack([ds_a[i] for i in range(EVAL_BATCH)]))
    x = center_crop_normalize(raw.to(trainer.device), cfg.model.image_size)
    ms = cuda_ms(lambda: trainer.translate(state.ema, x), iters=5, warmup=1)
    out = {"translate_img_per_s": 1e3 * EVAL_BATCH / ms}
    for kind in ("random", "inception"):
        c = apply_overrides(cfg, [f"eval.fid_features={kind}"])
        card, name = make_feature_fn(c, "cuda")
        cpu, _ = make_feature_fn(c, "cpu")
        got, want = card(x[:2]).cpu(), cpu(x[:2].cpu())
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not err <= EVAL_FEATURE_TOL * scale:
            raise AssertionError(f"eval: {name} card vs CPU {err} of {scale}")
        ms = cuda_ms(lambda: card(x), iters=5, warmup=1)
        out[name] = {"card_vs_cpu_err": err, "largest": scale,
                     "img_per_s": 1e3 * EVAL_BATCH / ms,
                     "ms_per_batch": ms}
    return out


def _vqgan_eval(work: str, count) -> dict:
    """``vqgan512`` through the same commands, in bf16: a run directory of
    its seeded state (checkpoint 0); ``sample`` of VQ_SAMPLES uniform codes
    (the decoder's 2 attention blocks, one batch) and eval-fid of its
    reconstructions (4 attention blocks an apply). ``count()`` adds the
    launches so far to the phase's and sets them to 0."""
    from PIL import Image

    from uig_torch import kernels as K
    from uig_torch.checkpoint import CheckpointManager, dump_run_config
    from uig_torch.cli.eval_fid import run_eval_fid
    from uig_torch.cli.sample import run_sample
    from uig_torch.config import apply_overrides, config_to_dict, get_preset
    from uig_torch.train import VQGANTrainer

    t0 = time.perf_counter()
    run = os.path.join(work, "vq")
    cfg = get_preset(VQ_PRESET)
    dump_run_config(config_to_dict(cfg), run)
    state = VQGANTrainer(apply_overrides(cfg, ["loss.lambda_lpips=0"])
                         ).init_state(SEED)
    CheckpointManager(os.path.join(run, "ckpt")).save(0, state)
    del state
    bf16 = ["model.eval_dtype=bfloat16", "eval.fid_features=random"]
    count()
    n = run_sample(run, os.path.join(work, "vq_samples"), n=VQ_SAMPLES,
                   overrides=bf16)
    sample_launches = K.launch_counts()["attention_fwd"]
    count()
    imgs = np.stack([np.asarray(Image.open(os.path.join(
        work, "vq_samples", f"{i:05d}.png"))) for i in range(n)])
    fid = run_eval_fid(run, num_samples=VQ_EVAL_SAMPLES,
                       batch_size=VQ_SAMPLES, overrides=bf16)
    eval_launches = K.launch_counts()["attention_fwd"]
    count()
    want = (2, 4 * VQ_EVAL_SAMPLES // VQ_SAMPLES)
    if (sample_launches, eval_launches) != want or not np.isfinite(fid) \
            or imgs.shape != (VQ_SAMPLES, 512, 512, 3):
        raise AssertionError(f"eval: vqgan512 sample/eval launched "
                             f"{sample_launches}/{eval_launches} (want "
                             f"{want}), FID {fid}, {imgs.shape}")
    return {"vqgan512_bf16_fid": fid, "vqgan512_samples": list(imgs.shape),
            "vqgan512_attention_launches": {"sample": sample_launches,
                                            "eval_fid": eval_launches},
            "vqgan512_seconds": time.perf_counter() - t0}


def phase_eval(run_a: str, work: str) -> dict:
    """Evaluate phase fit's run A (``cyclegan256_dp`` as published, 6
    steps): bf16 translate of its EMA beside fp32 (``_bf16_translate``);
    ``run_eval_fid`` in-process on EVAL_SAMPLES eval images a side with the
    random-conv and the untrained InceptionV3 extractors (FID twice, bit
    for bit, each; KID and PRDC with the random-conv one), launches
    counted over the first; the extractors on the card against the CPU
    and the img/s of each step; ``fid-stats`` of the B eval images then
    ``--ref-stats``, equal to the streamed FID; one in-training FID
    (``loop._inline_fid``) at INLINE_FID_SAMPLES; and ``vqgan512`` through
    ``sample`` and ``eval-fid`` in bf16. Returns the launches of the eval
    commands (eval-fid, fid-stats, the in-training FID, sample; not the
    timing loops nor the comparisons with the CPU) and those of one bf16
    translate apply."""
    import torch

    from uig_torch import kernels as K
    from uig_torch.cli.eval_fid import run_eval_fid
    from uig_torch.cli.fid_stats import run_fid_stats
    from uig_torch.cli.translate import load_run
    from uig_torch.config import load_config
    from uig_torch.data import eval_datasets
    from uig_torch.eval.fid import make_feature_fn
    from uig_torch.train.loop import _inline_fid

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    totals = {k: 0 for k in PER_APPLY}

    def add_counts():
        for k, v in K.launch_counts().items():
            totals[k] += v
        K.reset_launch_counts()

    out = {"phase": "eval", "preset": PRESET, "run": "fit run A",
           "samples": EVAL_SAMPLES, "batch": EVAL_BATCH}
    out.update(_bf16_translate(run_a))
    K.reset_launch_counts()  # timing loops: not counted
    metrics = {}
    for kind in ("random", "inception"):
        over = [f"eval.fid_features={kind}"]
        kw = dict(num_samples=EVAL_SAMPLES, batch_size=EVAL_BATCH,
                  overrides=over)
        t0 = time.perf_counter()
        fid = run_eval_fid(run_a, **kw)
        secs = time.perf_counter() - t0
        counts = K.launch_counts()
        add_counts()
        applies = EVAL_SAMPLES // EVAL_BATCH
        if counts != {k: applies * v for k, v in PER_APPLY.items()}:
            raise AssertionError(f"eval: eval-fid ({kind}) launched {counts}")
        again = run_eval_fid(run_a, **kw)
        metrics[kind] = {"fid": fid, "fid_repeat_bit_equal": True,
                         "fid_seconds": secs, "launches": counts}
        if kind == "random":
            metrics[kind].update(kid=run_eval_fid(run_a, kid=True, **kw),
                                 prdc=run_eval_fid(run_a, prdc=True, **kw))
        add_counts()
        kid = metrics[kind].get("kid", (0.0,))
        if again != fid or not np.isfinite(fid) or not np.isfinite(kid[0]):
            raise AssertionError(f"eval: {kind} FID {fid} then {again}, "
                                 f"KID {kid}")
    out["eval_fid"] = metrics
    out["extractors"] = _features_and_rates(run_a)
    K.reset_launch_counts()  # timing loops: not counted

    # fid-stats of the B eval images, then --ref-stats
    cfg = load_config(os.path.join(run_a, "config.json"))
    _, ds_b = eval_datasets(cfg)
    packed = os.path.join(work, "b_eval.npy")
    np.save(packed, np.stack([ds_b[i] for i in range(EVAL_SAMPLES)]))
    stats = os.path.join(work, "b_stats.npz")
    t0 = time.perf_counter()
    name = run_fid_stats(packed, stats, cfg.model.image_size,
                         batch_size=EVAL_BATCH, load_size=cfg.data.load_size)
    stats_s = time.perf_counter() - t0
    ref = run_eval_fid(run_a, num_samples=EVAL_SAMPLES, batch_size=EVAL_BATCH,
                       ref_stats=stats)
    add_counts()
    if name != "random_conv" or ref != metrics["random"]["fid"]:
        raise AssertionError(f"eval: --ref-stats FID {ref} != streamed "
                             f"{metrics['random']['fid']} ({name})")
    out.update(ref_stats_fid_equal=True, fid_stats_seconds=stats_s)

    # one in-training FID at smalldata64's sample count
    c200, trainer, state = load_run(run_a, overrides=[
        f"eval.fid_num_samples={INLINE_FID_SAMPLES}", "loss.lambda_lpips=0"])
    feature, _ = make_feature_fn(c200, trainer.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fid200 = _inline_fid(c200, trainer, state, feature)
    out.update(inline_fid_200=fid200,
               inline_fid_200_seconds=time.perf_counter() - t0)
    del trainer, state
    add_counts()
    torch.cuda.empty_cache()
    out.update(_vqgan_eval(work, add_counts))
    missing = [k for k in ("instance_norm", "conv3_in_act", "conv7",
                           "conv3s2", "attention_fwd") if totals[k] < 1]
    if missing:
        raise AssertionError(f"eval: {missing} never launched")
    out.update(launches=totals, seconds=time.perf_counter() - t_phase,
               nvidia_smi=nvidia_smi())
    emit(out)
    return totals, out["bf16_launches_per_apply"]


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def seeded_flax_weights(path: str) -> None:
    """Flax-layout flat weights for the full-width preset, from a seed:
    normal(0.02) kernels and biases, instance norm scale 1 + 0.1 N and
    bias 0.1 N."""
    from uig_torch.config import get_preset
    from uig_torch.convert import flax_from_generator_state
    from uig_torch.models import generator_from_config

    shapes = flax_from_generator_state(
        generator_from_config(get_preset(PRESET).model).state_dict())
    rng = np.random.default_rng(SEED)
    flat = {}
    for key, ref in shapes.items():
        if key.endswith("/scale"):
            v = 1.0 + 0.1 * rng.standard_normal(ref.shape)
        elif key.endswith("/bias") and key[:-5] + "/scale" in shapes:
            v = 0.1 * rng.standard_normal(ref.shape)
        else:
            v = 0.02 * rng.standard_normal(ref.shape)
        flat[key] = v.astype(np.float32)
    np.savez(path, **flat)


def phase_slice(weights: str):
    import torch

    from uig_torch import kernels as K
    from uig_torch.serving import Translator

    t0 = time.perf_counter()
    tr = Translator(PRESET, weights, batch_size=BATCH)
    load = tr.load
    rng = np.random.default_rng(SEED + 1)
    raw = rng.integers(0, 256, (BATCH, load, load, 3), dtype=np.uint8)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    K.reset_launch_counts()
    out1 = tr(raw)  # the main path's run
    launches = K.launch_counts()
    if launches != PER_APPLY:
        raise AssertionError(f"launches per apply {launches} != {PER_APPLY}")
    K.reset_launch_counts()
    out2 = tr(raw)
    if K.launch_counts() != PER_APPLY:
        raise AssertionError(f"second apply launched {K.launch_counts()}")
    if out1.shape != (BATCH, tr.crop, tr.crop, 3) or out1.dtype != np.uint8:
        raise AssertionError(f"output {out1.dtype} {out1.shape}")
    if not np.array_equal(out1, out2):
        raise AssertionError("two runs on the same batch differ")
    spread = int(out1.max()) - int(out1.min())
    if spread < 64:
        raise AssertionError(f"output nearly constant (spread {spread})")

    t1 = time.perf_counter()
    cpu = Translator(PRESET, weights, batch_size=2, device="cpu")
    ref = cpu(raw[:2])
    cpu_s = time.perf_counter() - t1
    cpu_diff = int(np.abs(ref.astype(np.int16) - out1[:2]).max())
    if cpu_diff > 1:
        raise AssertionError(f"card vs CPU plain: {cpu_diff} uint8 steps")
    n_off = int((ref != out1[:2]).sum())

    iters = 10
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(iters):
        tr(raw)
    wall = (time.perf_counter() - t2) / iters
    x = torch.from_numpy(raw).to(tr.device)
    from uig_torch.kernels.augment import center_crop_normalize
    xf = center_crop_normalize(x, tr.crop)
    torch.cuda.reset_peak_memory_stats()
    gen_ms = cuda_ms(lambda: tr.translate_float(xf), iters=iters, warmup=2)
    emit({"phase": "slice", "preset": PRESET, "batch": BATCH,
          "output": list(out1.shape), "byte_identical_repeat": True,
          "cpu_plain_max_step": cpu_diff, "cpu_plain_pixels_off": n_off,
          "cpu_plain_seconds": cpu_s, "setup_seconds": build_s,
          "launches_per_apply": launches,
          "translate_ms_per_batch": 1e3 * wall,
          "img_per_s": BATCH / wall,
          "generator_ms_per_batch": gen_ms,
          "generator_img_per_s": 1e3 * BATCH / gen_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    # every profiled apply's output bit-equal to the first apply's: a
    # witness that does not depend on the profiler's records
    outs = []
    prof = profile_call(lambda: outs.append(tr(raw)), "profile", calls=True)
    if not all(np.array_equal(o, out1) for o in outs):
        raise AssertionError("a profiled apply's output differs")
    prof["profiled_outputs_bit_equal"] = len(outs)
    calls = prof.pop("calls")
    prof["designs"] = designs_run(calls, "slice", PER_APPLY,
                                  expect=SLICE_DESIGNS)
    prof["design_calls"] = design_calls(calls)
    emit(prof)
    return tr, launches


def profile_call(fn, phase: str, calls: bool = False) -> dict:
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    and the share of the call's wall time that the card was busy; the
    host's issue time (until ``fn`` returns, before the synchronize) and
    the host time spent in the runtime's launch calls, both with the
    profiler on; with ``calls``, also the launches by CUDA function
    name. A capture that recorded no device event at all (one or two
    sessions in a hundred on an H100, short ones) is taken again, up to
    PROFILE_TRIES calls of ``fn``; the last capture counts. With ``calls``,
    so is a capture that recorded fewer launches of a kernel's functions
    than its wrapper counted over the same call (``short_records``); each
    such capture is listed under ``lost_records``. Each capture opens with
    a device spin of ~PROFILE_SPIN_MS that is waited for before ``fn``
    runs: the profiler loses the first records of a capture, more of them
    the older the process (``tools/cupti_records.py``), and then loses the
    spin's (``spin_recorded`` false) instead of the call's. The spin is
    left out of every reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uig_torch import kernels as K

    lost = []
    for attempt in range(1, PROFILE_TRIES + 1):
        K.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(int(PROFILE_SPIN_MS * 2e6))  # ~2 GHz clock
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        counted = K.launch_counts()
        by_name: dict = {}
        launches = []
        spin = False
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if "spin_kernel" in e.name:
                    spin = True
                    continue
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
            elif e.name.startswith(("cudaLaunch", "cuLaunch")):
                launches.append((e.time_range.start,
                                 e.time_range.elapsed_us()))
        launches = sorted(launches)[1:]  # the spin's launch first
        launch_api = [len(launches), sum(us for _, us in launches)]
        by_fn = launches_by_function({k: n for k, (n, _) in by_name.items()})
        short = short_records(by_fn, counted) if calls and by_name else {}
        if short:
            lost.append({"attempt": attempt, "short": short})
        if by_name and not short:
            break
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    out = {"phase": phase, "wall_ms": wall_ms, "host_issue_ms": host_ms,
           "launch_api_calls": launch_api[0],
           "launch_api_ms": (launch_api[1] / 1e3 if launch_api[0]
                             else "not measured"),
           "device_busy_ms": busy_ms if by_name else "not measured",
           "device_busy_share": (busy_ms / wall_ms if by_name
                                 else "not measured"),
           "device_kernels": sum(n for n, _ in by_name.values()),
           "capture_attempts": attempt, "spin_recorded": spin,
           "top": [{"kernel": k[:70], "calls": n, "ms": us / 1e3}
                   for k, (n, us) in top]}
    if calls:
        out["calls"] = by_fn
        out["lost_records"] = lost
    return out


def short_records(calls: dict, counted: dict) -> dict:
    """{kernel: [records, launches]} for each kernel of DESIGNS whose
    functions a capture recorded fewer times (the most of any one design's
    functions) than its wrapper counted launches over the same call."""
    out = {}
    for name, by_design in DESIGNS.items():
        n = counted.get(name, 0)
        seen = max(min(calls.get(fn, 0) for fn in design_functions(name, d))
                   for d in by_design)
        if seen < n:
            out[name] = [seen, n]
    return out


def wgmma_ptxas(log: list, key: str | tuple = "wgmma") -> list:
    """The entry points whose name holds ``key``, or one of the keys (the
    wgmma kernels; "_tc_kernel" and "tf32", the kernels in the three-term
    TF32 split) with the registers and spills that ptxas reported for each,
    from the build log's per-source sections."""
    keys = (key,) if isinstance(key, str) else key
    out, keep = [], False
    for sec in log:
        for ln in sec.splitlines():
            if "entry function" in ln:
                keep = any(k in ln for k in keys)
            if keep and ("entry function" in ln or "registers" in ln
                         or "spill" in ln):
                out.append(ln.strip())
        keep = False
    return out


def launches_by_function(by_name: dict) -> dict:
    """{CUDA function: launches} from the profiler's {kernel name:
    launches}: a name such as ``void (anonymous namespace)::f<16, 0>(...)``
    counts for ``f``; a name with no argument list counts as itself."""
    out: dict = {}
    for k, n in by_name.items():
        m = re.search(r"(\w+)[<(]", k)
        fn = m.group(1) if m else k
        out[fn] = out.get(fn, 0) + n
    return out


# ---------------------------------------------------------------------------
# phases 6 and 7: the VQGAN reconstruct path and training step
# ---------------------------------------------------------------------------


def seeded_vq_weights(path: str) -> None:
    """Flax-layout weights for ``vqgan512`` at full width, drawn from a
    seed by flax's initializers (``convert.seeded_flax``)."""
    from uig_torch.config import get_preset
    from uig_torch.convert import seeded_flax
    from uig_torch.models import generator_from_config

    np.savez(path, **seeded_flax(
        generator_from_config(get_preset(VQ_PRESET).model), SEED))


def _code_agreement(z_card, z_cpu, codes_card, codes_cpu, codebook) -> dict:
    """Codes must agree wherever the gap between a latent's two nearest
    codewords exceeds what the card's and the CPU's encoder outputs can
    move it by: |d(z', e_j) - d(z', e_k) - (d(z, e_j) - d(z, e_k))|
    <= 4 |z' - z| max|e|, plus 1e-5 (|z|^2 + max|e|^2) for the rounding of
    fp32 distances in either package. Distances in float64."""
    import torch

    cb = codebook.detach().double().cpu()
    z = z_cpu.double().reshape(-1, cb.shape[1])
    d = ((z ** 2).sum(1, keepdim=True) - 2.0 * z @ cb.T
         + (cb ** 2).sum(1)[None, :])
    two = torch.topk(d, 2, dim=1, largest=False).values
    gap = two[:, 1] - two[:, 0]
    dz = (z_card.double().cpu().reshape(z.shape) - z).norm(dim=1)
    e_max = cb.norm(dim=1).max()
    margin = 4.0 * dz * e_max + 1e-5 * ((z ** 2).sum(1) + e_max ** 2)
    checked = gap > margin
    differ = codes_card.flatten().cpu() != codes_cpu.flatten().cpu()
    return {"latents": int(z.shape[0]), "checked": int(checked.sum()),
            "differ_checked": int((differ & checked).sum()),
            "differ_within_margin": int((differ & ~checked).sum()),
            "min_gap": float(gap.min()), "max_margin": float(margin.max())}


def phase_vqgan_slice(weights: str) -> dict:
    import torch

    from uig_torch import kernels as K
    from uig_torch.kernels.augment import center_crop_normalize
    from uig_torch.serving import Translator, exact_fp32

    t0 = time.perf_counter()
    tr = Translator(VQ_PRESET, weights, batch_size=VQ_BATCH)
    rng = np.random.default_rng(SEED + 7)
    raw = rng.integers(0, 256, (VQ_BATCH, tr.load, tr.load, 3),
                       dtype=np.uint8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    K.reset_launch_counts()
    out1 = tr(raw)  # the main path's run
    launches = K.launch_counts()
    if launches != VQ_PER_APPLY:
        raise AssertionError(f"launches per apply {launches} != "
                             f"{VQ_PER_APPLY}")
    K.reset_launch_counts()
    out2 = tr(raw)
    if K.launch_counts() != VQ_PER_APPLY:
        raise AssertionError(f"second apply launched {K.launch_counts()}")
    if out1.shape != (VQ_BATCH, tr.crop, tr.crop, 3) or out1.dtype != np.uint8:
        raise AssertionError(f"output {out1.dtype} {out1.shape}")
    if not np.array_equal(out1, out2):
        raise AssertionError("two runs on the same batch differ")
    if int(out1.max()) - int(out1.min()) < 64:
        raise AssertionError("output nearly constant")

    # card against CPU (plain versions) at batch 1
    t1 = time.perf_counter()
    cpu = Translator(VQ_PRESET, weights, batch_size=1, device="cpu")
    x = center_crop_normalize(torch.from_numpy(raw[:1]), tr.crop)
    with torch.inference_mode(), exact_fp32():
        z_card = tr.generator.encoder(x.to(tr.device))
        vq_card = tr.generator.quantizer(z_card)
        z_cpu = cpu.generator.encoder(x)
        vq_cpu = cpu.generator.quantizer(z_cpu)
        codes = vq_cpu.codes
        img_card = tr.generator.decode_codes(codes.to(tr.device)).cpu()
        img_cpu = cpu.generator.decode_codes(codes)
    z_err = ((z_card.cpu() - z_cpu).abs().max() / z_cpu.abs().max()).item()
    agree = _code_agreement(z_card, z_cpu, vq_card.codes, vq_cpu.codes,
                            cpu.generator.quantizer.codebook)
    img_err = (img_card - img_cpu).abs().max().item()
    u8_card = tr.decode_codes(codes.numpy())
    u8_cpu = cpu.decode_codes(codes.numpy())
    u8_steps = int(np.abs(u8_card.astype(np.int16) - u8_cpu).max())
    cpu_s = time.perf_counter() - t1
    bad = {}
    if z_err > VQ_TOL["z"]:
        bad["z"] = z_err
    if agree["differ_checked"]:
        bad["codes"] = agree
    if img_err > VQ_TOL["image"] or u8_steps > 1:
        bad["decode_codes"] = (img_err, u8_steps)

    iters = 5
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(iters):
        tr(raw)
    wall = (time.perf_counter() - t2) / iters
    xf = center_crop_normalize(torch.from_numpy(raw).to(tr.device), tr.crop)
    torch.cuda.reset_peak_memory_stats()
    gen_ms = cuda_ms(lambda: tr.translate_float(xf), iters=iters, warmup=1)
    lat = tr.generator.encoder.latent_resolution
    codes4 = rng.integers(0, tr.cfg.model.vq_codebook_size,
                          (VQ_BATCH, lat, lat))
    dec_ms = cuda_ms(lambda: tr.decode_codes(codes4), iters=iters, warmup=1)
    with torch.inference_mode(), exact_fp32():
        vq4 = tr.generator.encode(xf)
    emit({"phase": "vqgan_slice", "preset": VQ_PRESET, "batch": VQ_BATCH,
          "output": list(out1.shape), "byte_identical_repeat": True,
          "launches_per_apply": launches, "setup_seconds": setup_s,
          "cpu_batch1_seconds": cpu_s, "z_rel_err": z_err,
          "z_tol": VQ_TOL["z"], "codes": agree,
          "decode_codes_max_abs_err": img_err,
          "decode_codes_tol": VQ_TOL["image"],
          "decode_codes_u8_max_step": u8_steps,
          "distinct_codes": int(vq4.codes.unique().numel()),
          "perplexity": float(vq4.perplexity),
          "reconstruct_ms_per_batch": 1e3 * wall,
          "reconstruct_img_per_s": VQ_BATCH / wall,
          "generator_ms_per_batch": gen_ms,
          "generator_img_per_s": 1e3 * VQ_BATCH / gen_ms,
          "decode_codes_ms_per_batch": dec_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    if bad:
        raise AssertionError(f"vqgan_slice card vs CPU: {bad}")
    emit(profile_call(lambda: tr(raw), "vqgan_slice_profile"))
    return launches


def phase_vqgan_train(overrides=VQ_OVERRIDES, phase: str = "vqgan_train",
                      steps: int = VQ_TRAIN_STEPS) -> tuple:
    """The VQGAN training step of ``VQ_PRESET`` with ``overrides``: the
    main path's launches, 3 steps twice byte-identical, the batch-1
    card-vs-CPU check of its dtype, ``steps`` steps finite with a falling
    ``rec`` and timed, and a profiled step. Returns the step's launches
    and the design each attention kernel ran."""
    import torch

    from uig_torch import kernels as K
    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.train import VQGANTrainer

    cfg = apply_overrides(get_preset(VQ_PRESET), overrides)
    load = cfg.data.load_size
    rng = np.random.default_rng(SEED + 8)
    a, b = (rng.integers(0, 256, (VQ_BATCH, load, load, 3), dtype=np.uint8)
            for _ in range(2))
    tr = VQGANTrainer(cfg)
    state0 = tr.init_state(SEED)
    out = {"phase": phase, "preset": VQ_PRESET, "overrides": overrides,
           "compute_dtype": cfg.model.compute_dtype,
           "batch_per_domain": VQ_BATCH, "union_batch": 2 * VQ_BATCH,
           "image": cfg.model.image_size}
    torch.use_deterministic_algorithms(True)
    try:
        # the main path's run: one step, with every count at 0 before it
        run_a = state0.clone()
        K.reset_launch_counts()
        run_a, _ = tr.train_step(run_a, (a, b))
        torch.cuda.synchronize()
        launches = K.launch_counts()
        if launches != VQ_PER_STEP:
            raise AssertionError(f"launches per VQGAN step {launches} != "
                                 f"{VQ_PER_STEP}")
        out["launches_per_step"] = launches
        for _ in range(2):
            run_a, _ = tr.train_step(run_a, (a, b))
        run_b = state0.clone()
        for _ in range(3):
            run_b, _ = tr.train_step(run_b, (a, b))
        ta, tb = state_tensors(run_a), state_tensors(run_b)
        differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
        if differ or state_counts(run_a) != state_counts(run_b):
            raise AssertionError(f"two 3-step runs differ in {differ[:5]}")
        out["byte_identical_3_steps"] = True
        out["state_tensors_compared"] = len(ta)
        del run_a, run_b, ta, tb

        loss_keys = ("g_loss", "d_loss", "rec", "codebook", "g_adv",
                     "perplexity", "lambda_adapt")
        if cfg.model.compute_dtype == "float32":
            compare_card_cpu(VQGANTrainer, cfg, a, b, loss_keys,
                             "vqgan_card_vs_cpu_batch1",
                             grad_metrics=("lambda_adapt", "g_loss"))
        else:
            compare_card_cpu_bf16(VQGANTrainer, cfg, a, b, loss_keys,
                                  f"{phase}_card_vs_cpu_batch1",
                                  grad_metrics=("lambda_adapt", "g_loss"))

        # steps on the fixed batch: finite, falling rec, timing
        st = state0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, hist = [], []
        for _ in range(steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            st, m = tr.train_step(st, (a, b))
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
            hist.append({k: float(v) for k, v in m.items()})
        bad = [h for h in hist if not all(np.isfinite(v) for v in h.values())]
        if bad:
            raise AssertionError(f"non-finite metrics: {bad[0]}")
        rec = [h["rec"] for h in hist]
        if not np.mean(rec[-3:]) < np.mean(rec[:3]):
            raise AssertionError(f"rec does not fall: {rec}")
        step_ms = float(np.median(times[2:]))
        out.update(
            steps=len(hist), rec=rec, first=hist[0], last=hist[-1],
            step_ms_median=step_ms, step_ms_timed=len(times[2:]),
            step_ms_min=float(np.min(times[2:])),
            step_ms_max=float(np.max(times[2:])),
            img_per_s=1e3 * 2 * VQ_BATCH / step_ms,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        emit(out)
        prof = profile_call(lambda: tr.train_step(st, (a, b)),
                            f"{phase}_profile", calls=True)
        calls = prof.pop("calls")
        prof["designs"] = designs_run(calls, phase, VQ_PER_STEP,
                                      VQ_STEP_DESIGNS)
        prof["design_calls"] = design_calls(calls)
        emit(prof)
    finally:
        torch.use_deterministic_algorithms(False)
    return launches, prof["designs"]


# ---------------------------------------------------------------------------
# phase 5: serve
# ---------------------------------------------------------------------------


def _post(port: int, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/translate", body=body,
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_serve(tr, weights: str) -> None:
    from PIL import Image

    from uig_torch.serve import start_server

    rng = np.random.default_rng(SEED + 2)
    imgs = rng.integers(0, 256, (12, tr.load, tr.load, 3), dtype=np.uint8)
    handle = start_server(PRESET, weights, batch_size=BATCH, port=0,
                          max_delay_ms=20.0)
    try:
        results = [None] * len(imgs)

        def worker(i):
            buf = io.BytesIO()
            Image.fromarray(imgs[i]).save(buf, format="PNG")
            results[i] = _post(handle.port, buf.getvalue())

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                raise AssertionError("a request did not return")
        for i, (status, body) in enumerate(results):
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status} {body[:200]}")
            got = np.asarray(Image.open(io.BytesIO(body)))
            want = tr(imgs[i:i + 1])[0]
            if got.shape != (tr.crop, tr.crop, 3) or not np.array_equal(got, want):
                raise AssertionError(f"request {i}: differs from Translator")
        conn = http.client.HTTPConnection("127.0.0.1", handle.port, timeout=30)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        handle.close()
    emit({"phase": "serve", "requests_ok": len(imgs), "stats": stats})


def main() -> int:
    # the checkout first: without it there is nothing to import
    if not os.path.isdir(os.path.join(ROOT, "src", "uig_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/uig_torch/ not found)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    from uig_torch.kernels import _build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log = open(_build.build_info["log"]).read().split("\n== ") \
        if "log" in _build.build_info else []
    ptxas = [ln.strip() for sec in log for ln in sec.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_version(),
          "device": torch.cuda.get_device_name(0),
          "build_seconds": build_s, "build_cached": _build.build_info["cached"],
          "ptxas": ptxas[:12], "ptxas_wgmma": wgmma_ptxas(log),
          "ptxas_tf32x3": wgmma_ptxas(log, ("_tc_kernel", "tf32")),
          "ptxas_mma": wgmma_ptxas(log, "_mma_kernel")})
    dev = torch.device("cuda", 0)
    totals = phase_kernels(dev)
    step_launches, designs, _ = phase_train(dev, steps=FP32_TRAIN_STEPS)
    torch.cuda.empty_cache()
    bf16_launches, bf16_designs, bf16_step_ms = phase_train(
        dev, TRAIN_OVERRIDES_BF16, "train_bf16")
    designs = {"float32": designs, "bfloat16": bf16_designs}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        cut_launches = phase_cut(work)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "g_a2b.npz")
        seeded_flax_weights(weights)
        tr, apply_launches = phase_slice(weights)
        phase_serve(tr, weights)
        del tr
        torch.cuda.empty_cache()
        vq_weights = os.path.join(tmp, "vqgan512.npz")
        seeded_vq_weights(vq_weights)
        vq_apply_launches = phase_vqgan_slice(vq_weights)
    torch.cuda.empty_cache()
    vq_step_launches, vq_designs = phase_vqgan_train()
    torch.cuda.empty_cache()
    vq_bf16_launches, vq_bf16_designs = phase_vqgan_train(
        VQ_OVERRIDES_BF16, "vqgan_train_bf16", VQ_BF16_TRAIN_STEPS)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        fit_launches, run_a = phase_fit(bf16_step_ms, work)
        eval_launches, bf16_apply_launches = phase_eval(run_a, work)
    kernels = []
    for name in PER_STEP:
        if name.startswith("attention"):
            dtypes = DTYPE_NAMES
            step_l = {"float32": vq_step_launches,
                      "bfloat16": vq_bf16_launches}
            kind_of = {"float32": vq_designs, "bfloat16": vq_bf16_designs}
            apply_l = vq_apply_launches
            per = (f"one {VQ_PRESET} training step at union batch "
                   f"{2 * VQ_BATCH} (fp32: vqgan_train; bf16: "
                   f"vqgan_train_bf16); per reconstruct apply at batch "
                   f"{VQ_BATCH} (fp32)")
        else:
            dtypes = DTYPE_NAMES
            step_l = {"float32": step_launches, "bfloat16": bf16_launches}
            kind_of = designs
            apply_l = apply_launches
            per = (f"one {PRESET} training step at batch {BATCH} (fp32: "
                   f"train; bf16: train_bf16); per translate apply at "
                   f"batch {BATCH} (fp32)")
        per_dtype = {}
        for dtype in dtypes:
            t = totals[(name, dtype)]
            if step_l[dtype][name] < 1:
                raise AssertionError(f"{name} never launched on the "
                                     f"{dtype} main path")
            kind = kind_of[dtype].get(name, "fma")
            per_dtype[dtype] = {"design": kind,
                                "source": (DESIGNS[name][kind][1]
                                           if name in DESIGNS
                                           else SOURCES[name]),
                                "launches": step_l[dtype][name],
                                "max_abs_err": t["max_abs_err"], **t["step"],
                                "bound_by": t["bound_by"]}
        t = totals[(name, "float32")]
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "design": per_dtype["float32"]["design"],
                 "replaces": REPLACES[name],
                 "launches": step_l["float32"][name],
                 "launches_per_translate_apply": apply_l[name],
                 "launches_fit": fit_launches[name],
                 "launches_per_bf16_translate_apply":
                     bf16_apply_launches[name],
                 "launches_eval": eval_launches[name],
                 "launches_cut": {p: cut_launches[p][name]
                                  for p in ("cut_fastcut256", "cut_cut256")},
                 "launches_dclgan": cut_launches["cut_dclgan256"][name],
                 "max_abs_err": t["max_abs_err"], **t["step"],
                 "bound_by": t["bound_by"], "dtypes": list(dtypes),
                 "per_dtype": per_dtype, "per": per}
        if apply_l[name]:
            entry["per_translate_apply"] = t["apply"]
        kernels.append(entry)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
