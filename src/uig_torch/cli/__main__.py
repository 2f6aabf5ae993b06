"""``python -m uig_torch.cli train|pack|translate|serve``: the port's
command line.

    python -m uig_torch.cli train (--preset cyclegan256_dp | --config C) \\
        [--max-steps N] [--set section.field=value ...] [--device cuda]
    python -m uig_torch.cli pack --input-dir D --output x.npy --load-size 286
    python -m uig_torch.cli translate --run-dir R [--step S] \\
        --input-dir D --output-dir O [--batch-size 8] [--device cuda]
    python -m uig_torch.cli translate --preset cyclegan256_dp --weights g.npz \\
        --input-dir D --output-dir O
    python -m uig_torch.cli serve --preset cyclegan256_dp --weights g.npz \\
        [--port 8000] [--max-delay-ms 5]

``train`` runs ``fit``: it writes ``<run.workdir>/<run.name>/`` (config.json,
metrics.jsonl, ckpt/, samples/) and resumes from its newest checkpoint; it
prints ``{"final_metrics": ...}``. ``--config`` takes a ``config.json`` in
place of a preset. ``translate --run-dir`` reads a run's config.json and the
EMA generator of its newest checkpoint (or ``--step``); ``--preset`` takes a
preset name or a ``config.json``, ``--weights`` a flat flax ``.npz``
(``uig_torch.convert``). ``--device cpu`` runs the plain PyTorch versions.
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
    from uig_torch.serve import run_serve

    return run_serve(args.preset, args.weights, args.direction,
                     args.batch_size, args.device, args.host, args.port,
                     args.max_delay_ms, args.overrides)


if __name__ == "__main__":
    sys.exit(main())
