"""Calibration CLI: measure, inspect, and diff calibration tables from
the command line.

    python -m repro_torch.calibrate run --out calib.json          # measure
    python -m repro_torch.calibrate show calib.json               # markdown
    python -m repro_torch.calibrate show calib.json --json        # raw state
    python -m repro_torch.calibrate diff old.json new.json        # what moved
    python -m repro_torch.calibrate --report calib.json ...       # nightly step

``run`` builds an emulated session (thread or process backend) whose
accelerator PEs live on the CUDA device (it raises without one), builds
the CUDA kernels, registers
the kernels' launch-parameter variants plus the radar app's ops, and
races every variant per PE kind across the shape-bucket ladder; the
resulting "rimms-calib-v1" file feeds ``Session(calibration=...)`` of
either package.  ``--report`` is the multi-file markdown form.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.core.calibrate import DEFAULT_LADDER, CalibrationTable

__all__ = ["main"]


def _parse_ladder(text: str) -> List[int]:
    out = []
    for part in text.split(","):
        part = part.strip().lower()
        if not part:
            continue
        mult = 1
        for suffix, m in (("kib", 1 << 10), ("mib", 1 << 20), ("k", 1 << 10),
                          ("m", 1 << 20)):
            if part.endswith(suffix):
                part, mult = part[: -len(suffix)], m
                break
        out.append(int(float(part) * mult))
    if not out:
        raise argparse.ArgumentTypeError("empty ladder")
    return out


def _cmd_run(args) -> int:
    # heavy imports deferred so `show`/`diff` stay fast
    import repro_torch.apps.radar  # noqa: F401  (registers radar ops + calib)
    from repro_torch.core.api import Session
    from repro_torch.core.autotune import autotune
    from repro_torch.kernels import _build

    accelerators = tuple(a for a in args.accelerators.split(",") if a)
    session = Session.emulated(n_cpu=args.n_cpu, accelerators=accelerators,
                               backend=args.backend)
    try:
        _build.library()  # nvcc before the first timed kernel
        table = autotune(session, nbytes=args.ladder, k=args.k,
                         warmup=args.warmup, seed=args.seed,
                         verbose=args.verbose,
                         extra_ops=("fft", "ifft", "zip"))
        table.meta["cli"] = {
            "n_cpu": args.n_cpu, "accelerators": list(accelerators),
            "backend": session.runtime.backend,
        }
        session.save_calibration(args.out)
    finally:
        session.close()
        session.runtime.close()  # reaps process-backend workers
    n_win = sum(1 for _, w in table.winners()
                if w.get("variant") != "default")
    print(f"wrote {args.out}: {len(table)} cells, "
          f"{len(table.winners())} winner rows "
          f"({n_win} non-default)", file=sys.stderr)
    if args.markdown:
        print(table.to_markdown())
    return 0


def _cmd_show(args) -> int:
    table = CalibrationTable.load(args.table)
    if args.json:
        json.dump(table.state(), sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        print(table.to_markdown())
    return 0


def _cmd_diff(args) -> int:
    a = CalibrationTable.load(args.a)
    b = CalibrationTable.load(args.b)
    delta = a.diff(b)
    json.dump(delta, sys.stdout, indent=1, sort_keys=True)
    print()
    return 1 if delta and args.exit_code else 0


def _cmd_report(paths: List[str]) -> int:
    status = 0
    for path in paths:
        try:
            table = CalibrationTable.load(path)
        except (OSError, ValueError) as e:
            print(f"error: {path}: {e}", file=sys.stderr)
            status = 1
            continue
        print(f"# Calibration report — {path}\n")
        print(table.to_markdown())
        print()
    return status


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--report":
        if not argv[1:]:
            print("usage: python -m repro_torch.calibrate --report TABLE...",
                  file=sys.stderr)
            return 2
        return _cmd_report(argv[1:])

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate",
        description="Measure, inspect, and diff RIMMS calibration tables "
                    "(rimms-calib-v1).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="measure a calibration table")
    run.add_argument("--out", required=True, metavar="TABLE.json")
    run.add_argument("--backend", default="thread",
                     choices=("thread", "process"),
                     help="kernel execution backend: 'process' measures "
                          "each cpu PE on its subprocess worker; the "
                          "CUDA PEs stay in-process")
    run.add_argument("--n-cpu", type=int, default=2)
    run.add_argument("--accelerators", default="gpu0",
                     help="comma-separated accelerator names (default gpu0)")
    run.add_argument("--ladder", type=_parse_ladder,
                     default=list(DEFAULT_LADDER),
                     help="comma-separated input sizes, e.g. 64KiB,1MiB,8MiB")
    run.add_argument("-k", type=int, default=5,
                     help="timed repeats per cell (median taken)")
    run.add_argument("--warmup", type=int, default=2)
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--markdown", action="store_true",
                     help="print the markdown report after measuring")
    run.add_argument("--verbose", action="store_true")
    run.set_defaults(fn=_cmd_run)

    show = sub.add_parser("show", help="print a table (markdown or JSON)")
    show.add_argument("table", metavar="TABLE.json")
    show.add_argument("--json", action="store_true")
    show.set_defaults(fn=_cmd_show)

    diff = sub.add_parser("diff", help="diff two tables")
    diff.add_argument("a", metavar="OLD.json")
    diff.add_argument("b", metavar="NEW.json")
    diff.add_argument("--exit-code", action="store_true",
                      help="exit 1 when the tables differ")
    diff.set_defaults(fn=_cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
