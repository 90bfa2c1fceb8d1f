"""Perf-regression gate over the port's BENCH_*.json records (a copy of
``benchmarks/check_regression.py``: host-only, so the port keeps its own
and imports nothing of the JAX package).

Each smoke benchmark emits a machine-readable record whose ``gate`` dict
holds *modeled*, machine-independent metrics (makespan under the
bandwidth model + static cost priors, exact ledger copy counts,
QoS-replay latencies).  This tool compares freshly produced records
against the reference's committed baselines of the same name under
``benchmarks/baselines/`` (read in place) and fails (exit 1) if any
gated metric regressed beyond its tolerance.

Tolerances: ``--tolerance`` (default 10%) applies to every metric; a
baseline file may override per metric via a top-level
``"gate_tolerances": {"metric": 0.25}`` dict — benchmarks embed these in
the records they emit, so committing a record as the baseline carries
its tolerances along.

Directions: gates default to upper bounds (lower is better).  A baseline
``"gate_directions": {"metric": "min"}`` flips a metric to a lower bound
(higher is better — e.g. the process backend's measured
``wall_speedup_vs_serial``).  A produced record may list metrics it
could not measure this run under ``"gate_skipped"`` (e.g. wall gates on
a runner with too few cores); those report SKIP instead of failing.

Reporting: a per-metric baseline-vs-current table with percent deltas is
always printed; ``--report PATH`` appends the same table as GitHub
markdown (CI points it at ``$GITHUB_STEP_SUMMARY``), and ``--json PATH``
writes the full machine-readable comparison.

Improvements are reported; to ratchet a baseline down, re-run the bench
locally and commit the new JSON.

Usage:
  python -m benchmarks_torch.check_regression BENCH_graph.json [...] \\
      [--baselines benchmarks/baselines] [--tolerance 0.10] \\
      [--report summary.md] [--json regressions.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

DEFAULT_BASELINES = (Path(__file__).resolve().parents[1] / "benchmarks"
                     / "baselines")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def check_file(produced: Path, baselines: Path, tolerance: float) -> dict:
    """Compare one produced record against its committed baseline.
    Returns ``{"name", "rows": [...], "failures": [...]}`` where each
    row is one gated metric's comparison."""
    out = {"name": produced.name, "rows": [], "failures": []}
    base_path = baselines / produced.name
    if not produced.exists():
        out["failures"].append(f"{produced.name}: produced record missing")
        return out
    if not base_path.exists():
        out["failures"].append(
            f"{produced.name}: no committed baseline at {base_path}"
        )
        return out
    rec = json.loads(produced.read_text())
    base = json.loads(base_path.read_text())
    gate, gate_base = rec.get("gate", {}), base.get("gate", {})
    if not gate or not gate_base:
        out["failures"].append(
            f"{produced.name}: missing 'gate' dict in record or baseline"
        )
        return out
    # Per-metric overrides live in the BASELINE (the committed contract).
    tols = dict(base.get("gate_tolerances", {}))
    # Direction per metric: "max" (default) gates an upper bound — lower
    # is better, FAIL above ref*(1+tol); "min" gates a lower bound —
    # higher is better (e.g. wall_speedup_vs_serial), FAIL below
    # ref*(1-tol).
    directions = dict(base.get("gate_directions", {}))
    # A produced record may declare baseline metrics it could not
    # measure this run (e.g. wall gates on a runner with too few cores)
    # — reported as SKIP, not as a vanished metric.
    skipped = set(rec.get("gate_skipped", []))
    for key, ref in sorted(gate_base.items()):
        if key not in gate:
            if key in skipped:
                out["rows"].append({
                    "metric": key, "baseline": ref, "current": None,
                    "delta_pct": None,
                    "tolerance": tols.get(key, tolerance),
                    "status": "SKIP",
                })
                continue
            out["failures"].append(
                f"{produced.name}: gated metric {key!r} vanished"
            )
            out["rows"].append({
                "metric": key, "baseline": ref, "current": None,
                "delta_pct": None, "tolerance": tols.get(key, tolerance),
                "status": "MISSING",
            })
            continue
        val = gate[key]
        tol = float(tols.get(key, tolerance))
        direction = directions.get(key, "max")
        if direction == "min":
            limit = ref * (1.0 - tol)
            failed = val < limit
            over = f"<{tol * 100:.0f}% under"
        else:
            limit = ref * (1.0 + tol)
            failed = val > limit
            over = f">{tol * 100:.0f}% over"
        delta = (val - ref) / ref * 100 if ref else 0.0
        status = "FAIL" if failed else "ok"
        out["rows"].append({
            "metric": key, "baseline": ref, "current": val,
            "delta_pct": delta, "tolerance": tol, "status": status,
        })
        if failed:
            out["failures"].append(
                f"{produced.name}: {key} regressed {delta:+.1f}% "
                f"({over} baseline {_fmt(ref)})"
            )
    return out


def print_table(results: List[dict]) -> None:
    print(f"{'bench':<28} {'metric':<24} {'baseline':>12} {'current':>12} "
          f"{'delta':>8} {'tol':>6} status")
    for res in results:
        for row in res["rows"]:
            delta = ("" if row["delta_pct"] is None
                     else f"{row['delta_pct']:+.1f}%")
            cur = "" if row["current"] is None else _fmt(row["current"])
            print(f"{res['name']:<28} {row['metric']:<24} "
                  f"{_fmt(row['baseline']):>12} {cur:>12} {delta:>8} "
                  f"{row['tolerance'] * 100:>5.0f}% {row['status']}")


def markdown_report(results: List[dict]) -> str:
    lines = ["## Perf-regression gate", "",
             "| bench | metric | baseline | current | delta | tol | status |",
             "|---|---|---:|---:|---:|---:|---|"]
    for res in results:
        if not res["rows"]:
            lines.append(f"| {res['name']} | — | | | | | "
                         f"{'FAIL' if res['failures'] else 'ok'} |")
        for row in res["rows"]:
            delta = ("" if row["delta_pct"] is None
                     else f"{row['delta_pct']:+.1f}%")
            cur = "" if row["current"] is None else _fmt(row["current"])
            mark = {"ok": "✅", "FAIL": "❌", "MISSING": "❌",
                    "SKIP": "⏭️"}.get(row["status"], row["status"])
            lines.append(
                f"| {res['name']} | `{row['metric']}` | "
                f"{_fmt(row['baseline'])} | {cur} | {delta} | "
                f"{row['tolerance'] * 100:.0f}% | {mark} |"
            )
    failures = [f for res in results for f in res["failures"]]
    lines.append("")
    if failures:
        lines.append(f"**{len(failures)} regression(s):**")
        lines += [f"- {f}" for f in failures]
    else:
        lines.append("**All gated metrics within tolerance.**")
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("produced", nargs="+", help="freshly emitted BENCH_*.json")
    ap.add_argument("--baselines", default=str(DEFAULT_BASELINES))
    ap.add_argument("--tolerance", type=float, default=0.10,
                    help="default allowed relative regression "
                         "(0.10 = 10%%); baselines may override per "
                         "metric via 'gate_tolerances'")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="append a GitHub-markdown comparison table to "
                         "PATH (use $GITHUB_STEP_SUMMARY in CI)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable comparison to PATH")
    args = ap.parse_args(argv)
    baselines = Path(args.baselines)
    results = [check_file(Path(p), baselines, args.tolerance)
               for p in args.produced]
    failures = [f for res in results for f in res["failures"]]

    print_table(results)
    if args.report:
        with open(args.report, "a") as fh:
            fh.write(markdown_report(results))
    if args.json:
        Path(args.json).write_text(json.dumps(
            {"results": results, "failures": failures,
             "default_tolerance": args.tolerance}, indent=1))
    for f in failures:
        print(f"REGRESSION: {f}", file=sys.stderr)
    if not failures:
        print("perf-regression gate: OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
