"""Hold this checkout against another one (for example the parent commit,
unpacked with ``git archive``) on one card, each checkout in its own
process with its own build:

- outputs at the training step's shapes that must be bit-identical: every
  CycleGAN kernel in both dtypes (K1, K2b, K3, K4f, K4d, K4w and K4s's
  forward, dgrad and wgrad; K2b from the plain version's statistics) and
  the attention kernels K5f and K5b at the VQGAN shapes, except the
  outputs in ``REPORTED``: K2f's (its sums run in another order than the
  parent's three-pass design) are reported as their largest difference and
  not held;
- the SASS of every kernel of the sources in ``SASS``: the bf16 wgmma and
  mma.sync kernels (``conv3_in_tc.cu``, ``conv3s2_tc.cu``,
  ``conv7_bwd_tc.cu``, ``conv7_wgrad_tc.cu``, ``conv7_tc.cu``), the fp32
  split kernels (``conv3_in_tf32.cu``, ``conv3s2_tf32.cu``,
  ``conv7_tf32.cu``, ``conv7_bwd_tf32.cu``, ``conv7_wgrad_tf32.cu``),
  ``attention.cu``'s and the FMA sources' (``augment.cu``, ``conv3_in.cu``,
  ``conv3s2.cu``, ``conv7.cu``, ``conv7_bwd.cu``), compiled from each
  checkout with the same nvcc flags and compared instruction by
  instruction (the kernels' anonymous-namespace prefix left out of their
  names; ``attention.cu``'s kernels by their identifier, so that a plain
  kernel and the fp32 instantiation of the same kernel as a template on
  the storage type meet): all must match; kernels only this checkout has
  are listed as new; ``instance_norm_bwd.cu`` (templated on the channels a
  thread holds) is compared and reported, not held;
- the ``cyclegan256_dp`` training step, timed in fp32 and in bf16, and the
  ``vqgan512`` step (union batch 8, D on from the first step) in fp32 and
  as published in bf16, in turns (this, other, other, this); after each
  run's steps, a digest of every tensor of its train state: the steps
  whose kernels ``STATE_REPORTED`` does not name must end in the same
  state as the other checkout's (every step runs K2f: all reported). The
  first step's gradients, from one seeded state and batch, are held to
  the other checkout's: in fp32 within ``GRAD_GAP`` of each network's
  largest gradient, in bf16 no further in the Euclidean norm than this
  checkout's bf16 step is from its fp32 step (``chip_smoke.py``'s
  card-vs-CPU gates); its losses reported as their relative difference; a
  ``Translator``
  apply of ``cyclegan256_dp`` (seeded weights, batch 8) within one uint8
  step (the smoke's card-vs-CPU translate gate).

    python3 tools/ab_checkouts.py OTHER_CHECKOUT

One JSON line a run, then one with the verdict, after the card's name and
power limit; exits non-zero if an output or a kernel's SASS differs. The
bf16 step runs with LPIPS off, which a checkout from before LPIPS was
ported needs.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED, BATCH, WARMUP, TIMED = 0, 8, 3, 10
OVERRIDES = {"float32": ["model.compute_dtype=float32", "loss.lambda_lpips=0"],
             "bfloat16": ["loss.lambda_lpips=0"]}
VQ_OVERRIDES = OVERRIDES["float32"] + ["loss.vq_disc_start=0"]
VQ_OVERRIDES_BF16 = ["loss.vq_disc_start=0"]
VQ_BATCH, VQ_TIMED = 4, 5  # per domain: the step trains on a union of 8
# outputs reported as their largest difference, not held bit-identical
REPORTED = tuple(f"{name} {t}" for t in ("float32", "bfloat16")
                 for name in ("instance_norm", "instance_norm stats"))
# training steps whose end state is reported, not held identical
STATE_REPORTED = ("float32", "bfloat16", "vqgan512", "vqgan512_bf16")
# the first step's gradient gap: fp32, relative to each network's largest
# gradient (chip_smoke.py GRAD_GAP); bf16, in the Euclidean norm, at most
# the gap between this checkout's bf16 and fp32 steps (FP32_TWIN; the bf16
# card-vs-CPU gate, compare_card_cpu_bf16: the kernels add less than bf16
# itself does); a translated image's, in uint8 steps
GRAD_GAP, TRANSLATE_GAP = 1e-2, 1
FP32_TWIN = {"bfloat16": "float32", "vqgan512_bf16": "vqgan512"}
# (source, the kernels compared: a substring of the name, whether their
# SASS must match)
SASS = (("conv3_in_tc.cu", "", True), ("conv3s2_tc.cu", "", True),
        ("conv7_bwd_tc.cu", "", True), ("conv7_wgrad_tc.cu", "", True),
        ("conv7_tc.cu", "", True), ("conv3_in_tf32.cu", "", True),
        ("conv3s2_tf32.cu", "", True), ("conv7_tf32.cu", "", True),
        ("conv7_bwd_tf32.cu", "", True), ("conv7_wgrad_tf32.cu", "", True),
        ("attention.cu", "", True), ("augment.cu", "", True),
        ("conv3_in.cu", "", True), ("conv3s2.cu", "", True),
        ("conv7.cu", "", True), ("conv7_bwd.cu", "", True),
        ("instance_norm_bwd.cu", "", False))


def worker(out: Path) -> None:
    """In the checkout whose ``src`` is on sys.path: save the fp32 outputs
    and print the step times."""
    import numpy as np
    import torch

    from uig_torch.config import apply_overrides, get_preset
    from uig_torch.kernels import (attention_bwd, attention_fwd,
                                   augment_batch, conv3_in_act, conv3s2,
                                   conv3s2_dgrad, conv3s2_wgrad, conv7,
                                   conv7_dgrad, conv7_wgrad, instance_norm,
                                   instance_norm_bwd)
    from uig_torch.kernels.norm import _instance_norm_fwd, _reference_fwd
    from uig_torch.serving import Translator, exact_fp32
    from uig_torch.train import CycleGANTrainer, VQGANTrainer

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def randn(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    outs = {}
    with exact_fp32():
        x, w = randn(BATCH, 64, 64, 256), randn(3, 3, 256, 256, scale=0.02)
        b, g, be = randn(256, scale=0.02), randn(256, scale=0.1) + 1, \
            randn(256, scale=0.1)
        dyn = randn(BATCH, 64, 64, 256)
        for dt in (torch.float32, torch.bfloat16):
            t = str(dt)[6:]
            for relu in (True, False):
                outs[f"conv3_in_act {t} relu={relu}"] = \
                    conv3_in_act(x.to(dt), w.to(dt), b, g, be,
                                 relu=relu).cpu()
            outs[f"instance_norm {t}"] = instance_norm(
                x.to(dt), g, be, relu=True).cpu()
            outs[f"instance_norm stats {t}"] = _instance_norm_fwd(
                x.to(dt), g, be, 1e-5, True)[1].cpu()
            # the backward from the plain version's statistics, which both
            # checkouts compute alike
            stats = _reference_fwd(x.to(dt), g, be, 1e-5, True)[1]
            for name, v in zip(("dx", "dgamma", "dbeta"), instance_norm_bwd(
                    x.to(dt), g, be, dyn.to(dt), stats, relu=True)):
                outs[f"instance_norm_bwd {name} {t}"] = v.cpu()
        for h, cin, cout in ((256, 64, 128), (128, 128, 256)):
            xs = randn(BATCH, h, h, cin)
            dy = randn(BATCH, h // 2, h // 2, cout)
            wd = randn(3, 3, cin, cout, scale=0.05)
            bd = randn(cout, scale=0.05)
            for dt in (torch.float32, torch.bfloat16):
                key = f"{str(dt)[6:]} {h} {cin}->{cout}"
                outs[f"conv3s2 {key}"] = conv3s2(
                    xs.to(dt), wd.to(dt), bd.to(dt)).cpu()
                outs[f"conv3s2_dgrad {key}"] = conv3s2_dgrad(
                    dy.to(dt), wd.to(dt)).cpu()
                outs[f"conv3s2_wgrad {key}"] = conv3s2_wgrad(
                    xs.to(dt), dy.to(dt)).cpu()
        for nb in (4, 8):
            q, k, v, do = (randn(nb, 1024, 512) for _ in range(4))
            o, lse = attention_fwd(q, k, v)[:2]  # fp32: o is the residual
            outs[f"attention_fwd {nb}"] = o.cpu()
            if nb == 8:
                for name, t in zip(("dq", "dk", "dv"),
                                   attention_bwd(q, k, v, o, lse, do)):
                    outs[f"attention_bwd {name} {nb}"] = t.cpu()
            del q, k, v, do, o, lse
        w7, b7 = randn(7, 7, 64, 3, scale=0.02), randn(3, scale=0.02)
        for nb in (2 * BATCH, BATCH):
            x7, dy7 = randn(nb, 256, 256, 64), randn(nb, 256, 256, 3)
            for dt in (torch.float32, torch.bfloat16):
                key = f"{str(dt)[6:]} {nb} reflect"
                outs[f"conv7 {key}"] = conv7(x7.to(dt), w7.to(dt), b7.to(dt),
                                             "reflect").cpu()
                outs[f"conv7_dgrad {key}"] = conv7_dgrad(
                    dy7.to(dt), w7.to(dt), "reflect").cpu()
                outs[f"conv7_wgrad {key}"] = conv7_wgrad(
                    x7.to(dt), dy7.to(dt), "reflect").cpu()
            del x7, dy7
    u8 = torch.from_numpy(rng.integers(0, 256, (BATCH, 286, 286, 3),
                                       dtype=np.uint8)).to(dev)
    oy, ox = (torch.from_numpy(rng.integers(0, 31, BATCH)) for _ in range(2))
    flip = torch.from_numpy(np.arange(BATCH) % 2 == 0)
    for dt in (torch.float32, torch.bfloat16):
        outs[f"augment_batch {dt}"] = augment_batch(u8, oy, ox, flip, 256,
                                                    dt).cpu()
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "g.npz")
        chip_smoke.seeded_flax_weights(weights)
        img = rng.integers(0, 256, (BATCH, 286, 286, 3), dtype=np.uint8)
        translated = Translator("cyclegan256_dp", weights, batch_size=BATCH)(
            img)
    outs["translate"] = torch.from_numpy(np.asarray(translated))

    times = {}
    torch.use_deterministic_algorithms(True)
    runs = [(dtype, "cyclegan256_dp", CycleGANTrainer, overrides, BATCH,
             TIMED) for dtype, overrides in OVERRIDES.items()]
    runs.append(("vqgan512", "vqgan512", VQGANTrainer, VQ_OVERRIDES,
                 VQ_BATCH, VQ_TIMED))
    runs.append(("vqgan512_bf16", "vqgan512", VQGANTrainer,
                 VQ_OVERRIDES_BF16, VQ_BATCH, VQ_TIMED))
    for key, preset, trainer, overrides, nb, timed in runs:
        cfg = apply_overrides(get_preset(preset), overrides)
        load = cfg.data.load_size
        # one batch for a preset's fp32 and bf16 runs (FP32_TWIN)
        batch_rng = np.random.default_rng(SEED + (preset == "vqgan512"))
        a_u8, b_u8 = (batch_rng.integers(0, 256, (nb, load, load, 3),
                                         dtype=np.uint8) for _ in range(2))
        tr = trainer(cfg)
        st = tr.init_state(SEED)
        # the first step's gradients and losses, from a copy of the state
        draws = tr.draw(st, nb, load, load)
        with exact_fp32():
            grads, metrics = tr._grads(st.clone(), (a_u8, b_u8), draws)
        outs[f"grads {key}"] = {k: v.detach().float().cpu()
                                for k, v in chip_smoke._flatten(grads).items()}
        outs[f"losses {key}"] = {k: float(v) for k, v in metrics.items()}
        del grads
        ms = []
        for i in range(WARMUP + timed):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            st, _ = tr.train_step(st, (a_u8, b_u8))
            e1.record()
            torch.cuda.synchronize()
            if i >= WARMUP:
                ms.append(e0.elapsed_time(e1))
        times[key] = {"step_ms_median": float(np.median(ms)), "step_ms": ms,
                      "state_sha256": state_digest(st)}
        del tr, st
        torch.cuda.empty_cache()
    torch.save(outs, out)
    print(json.dumps(times), flush=True)


def state_digest(st) -> str:
    """sha256 of every tensor of a train state (CycleGAN or VQGAN: the
    parameters, EMA, Adam moments, replay pools) and its counters, in name
    order."""
    import hashlib

    import torch

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            elif v is not None:
                yield prefix + k, v

    tensors = dict(flat({"g": st.g_params, "d": st.d_params, "ema": st.ema,
                         "g_mu": st.g_opt.mu, "g_nu": st.g_opt.nu,
                         "d_mu": st.d_opt.mu, "d_nu": st.d_opt.nu}))
    if hasattr(st, "pool_a"):
        tensors["pool_a"], tensors["pool_b"] = (st.pool_a.buffer,
                                                st.pool_b.buffer)
    h = hashlib.sha256(repr((st.step, st.g_opt.count,
                             st.d_opt.count)).encode())
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().contiguous().view(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def sass(checkout: Path, tmp: Path) -> dict:
    """{source: {kernel: instructions}} of the SASS sources compiled from
    ``checkout`` with this checkout's nvcc flags."""
    sys.path.insert(0, str(ROOT / "src"))
    from uig_torch.kernels import _build

    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    csrc = checkout / "src" / "uig_torch" / "csrc"
    out = {}
    for src, key, _ in SASS:
        cubin = tmp / (checkout.name + "_" + src + ".cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-I", str(csrc), "-o",
                        str(cubin), str(csrc / src)], check=True,
                       capture_output=True, timeout=600)
        text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
        fns, name = {}, None
        for ln in text.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                # the anonymous namespace's name holds a hash of the path
                name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                              m.group(1))
                fns[name] = []
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?;)", ln)
            if name is not None and m:
                fns[name].append(m.group(1))
        out[src] = {_sass_key(src, k): v for k, v in fns.items() if key in k}
    return out


def _sass_key(src: str, name: str) -> str:
    """A compiled kernel's name for the comparison: as it is, but for
    ``attention.cu``'s kernels their identifier, with the template
    arguments of a bf16 instantiation after it (the fp32 instantiation of
    a kernel templated on the storage type takes the plain kernel's key)."""
    m = re.search(r"(attn_[a-z0-9_]*?_kernel)(I.*?EE)?", name)
    if src != "attention.cu" or m is None:
        return name
    return m.group(1) + (f" {m.group(2)}" if "bfloat16" in name else "")


def run(checkout: Path, out: Path) -> dict:
    # cuBLAS runs deterministically only with a fixed workspace
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--worker", str(out)], cwd=str(checkout), env=env,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise SystemExit(f"worker in {checkout} failed:\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker))
        return 0
    import torch

    if not torch.cuda.is_available() or args.other is None:
        print("ab_checkouts: needs a CUDA device and another checkout",
              file=sys.stderr)
        return 1
    other = Path(args.other).resolve()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    names = {"this": ROOT, "other": other}
    outputs, states = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, who in enumerate(("this", "other", "other", "this")):
            out = Path(tmp) / f"{turn}_{who}.pt"
            times = run(names[who], out)
            outputs.setdefault(who, torch.load(out))
            states.setdefault(who, {k: v["state_sha256"]
                                    for k, v in times.items()})
            print(json.dumps({"turn": turn, "checkout": who,
                              **{k: v["step_ms_median"]
                                 for k, v in times.items()},
                              "state_sha256": {k: v["state_sha256"]
                                               for k, v in times.items()},
                              "step_ms": {k: v["step_ms"]
                                          for k, v in times.items()}}),
                  flush=True)
        mine, theirs = sass(ROOT, Path(tmp)), sass(other, Path(tmp))
    sass_same = {f"{src} {k}": v == theirs[src][k]
                 for src in mine for k, v in mine[src].items()
                 if k in theirs[src]}
    sass_same.update({f"{src} {k}": False for src in theirs
                      for k in theirs[src] if k not in mine[src]})
    sass_new = [f"{src} {k}" for src in mine for k in mine[src]
                if k not in theirs[src]]
    mine_out, theirs_out = outputs["this"], outputs["other"]
    same = {k: torch.equal(v, theirs_out[k]) for k, v in mine_out.items()
            if k not in REPORTED and k != "translate"
            and not k.startswith(("grads ", "losses "))}
    differ = {k: (mine_out[k].double()
                  - theirs_out[k].double()).abs().max().item()
              for k in REPORTED}
    # the steps' first gradients, per network, relative to its largest
    # gradient; the losses, relative; the translated batch, in uint8 steps
    gaps, held = {}, {}
    for key in states["this"]:
        mg, tg = mine_out[f"grads {key}"], theirs_out[f"grads {key}"]
        for net in ("g", "d"):
            leaves = [k for k in tg if k.startswith(net + "/")]
            top = max(tg[k].abs().max().item() for k in leaves)
            gaps[f"{key} {net}_grad"] = max(
                (mg[k] - tg[k]).abs().max().item() for k in leaves) / top
            if key not in FP32_TWIN:
                held[f"{key} {net}_grad"] = gaps[f"{key} {net}_grad"] <= GRAD_GAP
                continue
            fg = mine_out[f"grads {FP32_TWIN[key]}"]

            def norm(u, v):
                return sum(((u[k].double() - v[k].double()) ** 2).sum()
                           .item() for k in leaves) ** 0.5

            ratio = norm(mg, tg) / max(norm(mg, fg), 1e-30)
            gaps[f"{key} {net}_grad_norm_over_bf16_fp32"] = ratio
            held[f"{key} {net}_grad"] = ratio <= 1.0
    losses = {f"{key} {name}": abs(v - theirs_out[f"losses {key}"][name])
              / max(abs(theirs_out[f"losses {key}"][name]), 1e-30)
              for key in states["this"]
              for name, v in mine_out[f"losses {key}"].items()}
    translate_gap = (mine_out["translate"].int()
                     - theirs_out["translate"].int()).abs().max().item()
    required = [src for src, _, must in SASS if must]
    state_same = {k: v == states["other"].get(k)
                  for k, v in states["this"].items()}
    print(json.dumps({"bit_identical": same, "sass_identical": sass_same,
                      "sass_new": sass_new, "max_abs_difference": differ,
                      "step_state_identical": state_same,
                      "first_step_grad_gap": gaps,
                      "grad_gap_gate": GRAD_GAP, "grad_gap_held": held,
                      "first_step_loss_rel_diff": losses,
                      "translate_u8_gap": translate_gap,
                      "translate_gate": TRANSLATE_GAP}), flush=True)
    return 0 if all(same.values()) and all(
        v for k, v in state_same.items() if k not in STATE_REPORTED) and all(
        v for k, v in sass_same.items() if k.split()[0] in required) and all(
        held.values()) and translate_gap <= TRANSLATE_GAP else 1


if __name__ == "__main__":
    sys.exit(main())
