"""``python -m uig_torch.cli translate|serve``: the port's command line.

    python -m uig_torch.cli translate --preset cyclegan256_dp --weights g.npz \\
        --input-dir D --output-dir O [--batch-size 8] [--device cuda]
    python -m uig_torch.cli serve --preset cyclegan256_dp --weights g.npz \\
        [--port 8000] [--max-delay-ms 5]

``--preset`` takes a preset name or a ``config.json``;
``--weights`` a flat flax ``.npz`` (``uig_torch.convert``).
"""

from __future__ import annotations

import argparse
import json
import sys


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", required=True,
                   help="preset name or config.json")
    p.add_argument("--weights", required=True, help="flat flax .npz")
    p.add_argument("--direction", default="a2b", choices=("a2b", "b2a"))
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m uig_torch.cli",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("translate", help="translate a directory of images")
    _common(t)
    t.add_argument("--input-dir", required=True)
    t.add_argument("--output-dir", required=True)
    s = sub.add_parser("serve", help="HTTP micro-batching server")
    _common(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--max-delay-ms", type=float, default=5.0)
    args = ap.parse_args(argv)
    if args.cmd == "translate":
        from uig_torch.cli.translate import run_translate

        n = run_translate(args.preset, args.weights, args.input_dir,
                          args.output_dir, args.direction, args.batch_size,
                          args.device, args.overrides)
        print(json.dumps({"translated": n, "output_dir": args.output_dir}))
        return 0
    from uig_torch.serve import run_serve

    return run_serve(args.preset, args.weights, args.direction,
                     args.batch_size, args.device, args.host, args.port,
                     args.max_delay_ms, args.overrides)


if __name__ == "__main__":
    sys.exit(main())
