"""``python -m uig_torch.cli train|pack|translate|serve|eval-fid|fid-stats|sample``:
the port's command line.

    python -m uig_torch.cli train (--preset cyclegan256_dp | --config C) \\
        [--max-steps N] [--set section.field=value ...] [--device cuda]
    python -m uig_torch.cli pack --input-dir D --output x.npy --load-size 286
    python -m uig_torch.cli translate --run-dir R [--step S] \\
        --input-dir D --output-dir O [--batch-size 8] [--device cuda]
    python -m uig_torch.cli translate --preset cyclegan256_dp --weights g.npz \\
        --input-dir D --output-dir O
    python -m uig_torch.cli serve --preset cyclegan256_dp --weights g.npz \\
        [--port 8000] [--max-delay-ms 5]
    python -m uig_torch.cli eval-fid --run-dir R [--num-samples N] [--kid |
        --prdc [--prdc-k 5] | --inception-score [--is-splits 10] |
        --ref-stats stats.npz] [--step S] [--batch-size 16] [--device cuda]
    python -m uig_torch.cli fid-stats --data-dir D --output stats.npz \\
        --image-size 256 [--num-samples N] [--load-size L]
    python -m uig_torch.cli sample --run-dir R --output-dir O [-n 16] [--seed 0]

``train`` runs ``fit``: it writes ``<run.workdir>/<run.name>/`` (config.json,
metrics.jsonl, ckpt/, samples/) and resumes from its newest checkpoint; it
prints ``{"final_metrics": ...}``. ``--config`` takes a ``config.json`` in
place of a preset. ``translate --run-dir`` reads a run's config.json and the
EMA generator of its newest checkpoint (or ``--step``); ``--preset`` takes a
preset name or a ``config.json``, ``--weights`` a flat flax ``.npz``
(``uig_torch.convert``). ``eval-fid`` translates a run's eval images
through its EMA generator (in ``model.eval_dtype``) and prints the FID
(``--kid``, ``--prdc``, ``--inception-score``: that metric instead) over the
extractor of ``eval.fid_features`` (``eval/fid.py``); ``fid-stats`` saves a
dataset's reference statistics for ``--ref-stats``; ``sample`` decodes
uniform-random codes through a ``vqgan`` run's EMA decoder. ``--device cpu``
runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import sys


def _overrides(p: argparse.ArgumentParser) -> None:
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override")


def _serving(p: argparse.ArgumentParser, required: bool) -> None:
    p.add_argument("--preset", required=required,
                   help="preset name or config.json")
    p.add_argument("--weights", required=required, help="flat flax .npz")
    p.add_argument("--direction", default="a2b", choices=("a2b", "b2a"))
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", default="cuda")
    _overrides(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m uig_torch.cli",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="train (or resume) a run")
    src = tr.add_mutually_exclusive_group(required=True)
    src.add_argument("--preset", help="preset name")
    src.add_argument("--config", help="config.json (in place of a preset)")
    tr.add_argument("--max-steps", type=int, default=None)
    tr.add_argument("--device", default="cuda")
    _overrides(tr)
    pk = sub.add_parser("pack",
                        help="pre-decode an image folder into a memmapped .npy")
    pk.add_argument("--input-dir", required=True)
    pk.add_argument("--output", required=True, help=".npy output path")
    pk.add_argument("--load-size", type=int, required=True)
    t = sub.add_parser("translate", help="translate a directory of images")
    _serving(t, required=False)
    t.add_argument("--run-dir", help="a training run's directory (config.json "
                                     "+ ckpt/), in place of --preset/--weights")
    t.add_argument("--step", type=int, default=None,
                   help="with --run-dir: the checkpoint (default: newest)")
    t.add_argument("--input-dir", required=True)
    t.add_argument("--output-dir", required=True)
    s = sub.add_parser("serve", help="HTTP micro-batching server")
    _serving(s, required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--max-delay-ms", type=float, default=5.0)
    ev = sub.add_parser("eval-fid", help="FID of translated eval images")
    ev.add_argument("--run-dir", required=True)
    ev.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    ev.add_argument("--num-samples", type=int, default=None)
    ev.add_argument("--step", type=int, default=None)
    ev.add_argument("--batch-size", type=int, default=16)
    ev.add_argument("--kid", action="store_true",
                    help="report KID (unbiased small-sample metric) instead")
    ev.add_argument("--prdc", action="store_true",
                    help="report precision/recall/density/coverage (k-NN "
                         "manifold fidelity-vs-diversity) instead")
    ev.add_argument("--prdc-k", type=int, default=5,
                    help="k for the PRDC k-NN radius estimate (default 5)")
    ev.add_argument("--inception-score", action="store_true",
                    help="report Inception Score of the translated stream "
                         "instead (needs weights with the fc head)")
    ev.add_argument("--is-splits", type=int, default=10,
                    help="IS split count (default 10)")
    ev.add_argument("--diversity", type=int, default=0, metavar="N_SEEDS",
                    help="multimodal runs only (munit|starganv2, not ported)")
    ev.add_argument("--ref-stats", default=None,
                    help="precomputed real-domain statistics npz (from "
                         "fid-stats): skips streaming the reals; FID only")
    ev.add_argument("--target-domain", type=int, default=None,
                    help="multi-domain runs only (stargan, not ported)")
    ev.add_argument("--device", default="cuda")
    _overrides(ev)
    fs = sub.add_parser(
        "fid-stats", help="precompute a dataset's FID reference statistics "
                          "(reusable via eval-fid --ref-stats)")
    fs.add_argument("--data-dir", required=True,
                    help="image folder / packed .npy")
    fs.add_argument("--output", required=True, help="output .npz path")
    fs.add_argument("--image-size", type=int, required=True,
                    help="center-crop size — must match the eval run's "
                         "model.image_size")
    fs.add_argument("--num-samples", type=int, default=None)
    fs.add_argument("--batch-size", type=int, default=16)
    fs.add_argument("--load-size", type=int, default=None,
                    help="host resize before crop (default: config "
                         "data.load_size)")
    fs.add_argument("--source", default="auto",
                    choices=["auto", "folders", "packed", "tfrecord",
                             "webdataset"])
    fs.add_argument("--device", default="cuda")
    _overrides(fs)
    sm = sub.add_parser(
        "sample", help="unconditional generation (vqgan codes)")
    sm.add_argument("--run-dir", required=True)
    sm.add_argument("--output-dir", required=True)
    sm.add_argument("-n", type=int, default=16)
    sm.add_argument("--seed", type=int, default=0)
    sm.add_argument("--step", type=int, default=None)
    sm.add_argument("--device", default="cuda")
    _overrides(sm)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cmd == "train":
        from uig_torch.cli.train import run_train

        metrics = run_train(args.preset, args.config, args.overrides,
                            args.max_steps, args.device)
        print(json.dumps({"final_metrics": metrics}))
        return 0
    if args.cmd == "pack":
        from uig_torch.cli.train import run_pack

        n = run_pack(args.input_dir, args.output, args.load_size)
        print(json.dumps({"packed": n, "output": args.output}))
        return 0
    if args.cmd == "translate":
        from uig_torch.cli.translate import run_translate

        if args.run_dir is not None:
            if args.preset is not None or args.weights is not None:
                ap.error("translate takes --run-dir or --preset with "
                         "--weights, not both")
        elif args.preset is None or args.weights is None:
            ap.error("translate needs --run-dir, or --preset with --weights")
        elif args.step is not None:
            ap.error("--step needs --run-dir")
        n = run_translate(args.preset, args.weights, args.input_dir,
                          args.output_dir, args.direction, args.batch_size,
                          args.device, args.overrides, run_dir=args.run_dir,
                          step=args.step)
        print(json.dumps({"translated": n, "output_dir": args.output_dir}))
        return 0
    if args.cmd == "eval-fid":
        from uig_torch.cli.eval_fid import run_eval_fid

        res = run_eval_fid(args.run_dir, direction=args.direction,
                           num_samples=args.num_samples, step=args.step,
                           batch_size=args.batch_size,
                           overrides=args.overrides, kid=args.kid,
                           prdc=args.prdc, prdc_k=args.prdc_k,
                           inception_score=args.inception_score,
                           is_splits=args.is_splits, ref_stats=args.ref_stats,
                           diversity=args.diversity,
                           target_domain=args.target_domain,
                           device=args.device)
        if args.inception_score:
            print(json.dumps({"is": res[0], "is_std": res[1]}))
        elif args.prdc:
            print(json.dumps(res))
        elif args.kid:
            print(json.dumps({"kid": res[0], "kid_std": res[1]}))
        else:
            print(json.dumps({"fid": res}))
        return 0
    if args.cmd == "fid-stats":
        from uig_torch.cli.fid_stats import run_fid_stats

        extractor = run_fid_stats(
            args.data_dir, args.output, args.image_size,
            num_samples=args.num_samples, batch_size=args.batch_size,
            source=args.source, load_size=args.load_size,
            overrides=args.overrides, device=args.device)
        print(json.dumps({"stats": args.output, "extractor": extractor}))
        return 0
    if args.cmd == "sample":
        from uig_torch.cli.sample import run_sample

        n = run_sample(args.run_dir, args.output_dir, n=args.n,
                       seed=args.seed, step=args.step,
                       overrides=args.overrides, device=args.device)
        print(json.dumps({"sampled": n, "output_dir": args.output_dir}))
        return 0
    from uig_torch.serve import run_serve

    return run_serve(args.preset, args.weights, args.direction,
                     args.batch_size, args.device, args.host, args.port,
                     args.max_delay_ms, args.overrides)


if __name__ == "__main__":
    sys.exit(main())
