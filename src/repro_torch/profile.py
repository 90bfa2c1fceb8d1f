"""Profile report over exported RIMMS traces (the port's copy of the
reference's ``repro/profile.py``; pure JSON handling, no torch).

``python -m repro_torch.profile TRACE.json [TRACE2.json ...]`` prints, per
trace, a markdown report:

* **top-N ops by wall time** — wall-clock compute spans (pid 1) grouped
  by op;
* **top-N ops by modeled time** — the deterministic replay's compute
  spans (pid 2), same grouping, so wall vs modeled hot spots can be
  compared side by side;
* **critical path** — extracted from the trace's flow arrows (producer
  compute → consumer compute): the longest chain of modeled compute
  spans by summed duration, printed task by task;
* **divergence table** — the embedded wall/modeled calibration table
  (``doc["rimms"]["divergence"]``, written by
  :meth:`~repro_torch.core.trace.TraceCollector.set_divergence`)
  rendered as markdown.

The port's traces keep the reference's pids and schema, so both
packages' :func:`profile_report` give the same text for one trace
document.  A missing or malformed trace exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

WALL_PID = 1
MODEL_PID = 2

__all__ = ["profile_report", "main"]


def _tid_tracks(events: List[dict]) -> Dict[Tuple[int, int], str]:
    return {
        (e["pid"], e["tid"]): e.get("args", {}).get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }


def _op_of(e: dict) -> str:
    return e.get("args", {}).get("op") or e.get("name") or "?"


def _top_ops(events: List[dict], pid: int, top: int
             ) -> List[Tuple[str, float, int]]:
    """(op, total_us, count) for compute spans of ``pid``, descending."""
    totals: Dict[str, List[float]] = {}
    for e in events:
        if (e.get("ph") != "X" or e.get("pid") != pid
                or e.get("cat") != "compute"):
            continue
        acc = totals.setdefault(_op_of(e), [0.0, 0])
        acc[0] += e.get("dur", 0.0)
        acc[1] += 1
    ranked = sorted(totals.items(), key=lambda kv: (-kv[1][0], kv[0]))
    return [(op, t, int(n)) for op, (t, n) in ranked[:top]]


def _critical_path(events: List[dict]) -> Tuple[List[dict], float]:
    """Longest chain of modeled compute spans linked by flow arrows.

    Flow events come in ``ph="s"`` / ``ph="f"`` pairs sharing an ``id``;
    each endpoint lands inside the compute span it decorates, so the
    span is recovered by (tid, timestamp) containment.  Returns the
    chain (span dicts, in order) and its summed duration in us.
    """
    spans = [e for e in events
             if e.get("ph") == "X" and e.get("pid") == MODEL_PID
             and e.get("cat") == "compute"]
    by_tid: Dict[int, List[Tuple[float, float, int]]] = {}
    for i, e in enumerate(spans):
        by_tid.setdefault(e["tid"], []).append(
            (e["ts"], e["ts"] + e.get("dur", 0.0), i))
    for lst in by_tid.values():
        lst.sort()

    def locate(tid: int, ts: float) -> Optional[int]:
        for t0, t1, i in by_tid.get(tid, ()):
            if t0 <= ts <= t1:
                return i
        return None

    starts: Dict[Any, int] = {}
    ends: Dict[Any, int] = {}
    for e in events:
        if e.get("cat") != "flow" or e.get("pid") != MODEL_PID:
            continue
        idx = locate(e["tid"], e["ts"])
        if idx is None:
            continue
        if e.get("ph") == "s":
            starts[e.get("id")] = idx
        elif e.get("ph") == "f":
            ends[e.get("id")] = idx
    preds: Dict[int, List[int]] = {}
    for fid, src in starts.items():
        dst = ends.get(fid)
        if dst is not None and dst != src:
            preds.setdefault(dst, []).append(src)

    # Longest path by summed span duration; spans are finite and flows
    # point forward in modeled time, so plain memoized recursion works
    # (with a visiting guard against malformed cyclic input).
    best: Dict[int, Tuple[float, Optional[int]]] = {}
    visiting: set = set()

    def cost(i: int) -> Tuple[float, Optional[int]]:
        if i in best:
            return best[i]
        if i in visiting:
            return (0.0, None)
        visiting.add(i)
        dur = spans[i].get("dur", 0.0)
        choice: Tuple[float, Optional[int]] = (dur, None)
        for p in preds.get(i, ()):
            c = cost(p)[0] + dur
            if c > choice[0]:
                choice = (c, p)
        visiting.discard(i)
        best[i] = choice
        return choice

    if not spans:
        return [], 0.0
    tail = max(range(len(spans)), key=lambda i: cost(i)[0])
    total = cost(tail)[0]
    chain: List[dict] = []
    cur: Optional[int] = tail
    while cur is not None:
        chain.append(spans[cur])
        cur = best[cur][1]
    chain.reverse()
    return chain, total


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.3f}ms"
    return f"{us:.1f}us"


def _divergence_markdown(table: Dict[str, dict]) -> List[str]:
    lines = [
        "| kind | op | pe kind | bucket | n | wall | modeled | "
        "ema | mean | p95 |",
        "|---|---|---|---|---:|---:|---:|---:|---:|---:|",
    ]
    for key in sorted(table):
        c = table[key]
        def r(v: Any) -> str:
            return f"{v:.3f}" if isinstance(v, (int, float)) else "-"
        lines.append(
            f"| {c.get('kind', '?')} | {c.get('op', '?')} "
            f"| {c.get('pe_kind', '?')} | {c.get('bucket', '?')} "
            f"| {c.get('count', 0)} | {_fmt_us(c.get('wall_s', 0) * 1e6)} "
            f"| {_fmt_us(c.get('model_s', 0) * 1e6)} "
            f"| {r(c.get('ema_ratio'))} | {r(c.get('mean_ratio'))} "
            f"| {r(c.get('p95_ratio'))} |")
    return lines


def profile_report(doc: dict, *, top: int = 10,
                   title: str = "trace") -> str:
    """The markdown profile report for one exported trace dict."""
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("not a RIMMS trace: missing traceEvents list")
    lines: List[str] = [f"## Profile: {title}", ""]

    for label, pid in (("wall", WALL_PID), ("modeled", MODEL_PID)):
        ranked = _top_ops(events, pid, top)
        lines.append(f"### Top ops by {label} time")
        lines.append("")
        if not ranked:
            lines.append(f"_no {label} compute spans_")
        else:
            lines.append("| op | total | spans | mean |")
            lines.append("|---|---:|---:|---:|")
            for op, total, n in ranked:
                lines.append(f"| {op} | {_fmt_us(total)} | {n} "
                             f"| {_fmt_us(total / n)} |")
        lines.append("")

    chain, total = _critical_path(events)
    lines.append("### Critical path (modeled, via flow arrows)")
    lines.append("")
    if not chain:
        lines.append("_no flow arrows in trace_")
    else:
        lines.append(f"{len(chain)} tasks, {_fmt_us(total)} summed "
                     f"compute:")
        lines.append("")
        for e in chain:
            lines.append(f"1. `{e.get('name', '?')}` "
                         f"({_op_of(e)}, {_fmt_us(e.get('dur', 0.0))})")
    lines.append("")

    div = doc.get("rimms", {}).get("divergence")
    lines.append("### Wall/modeled divergence")
    lines.append("")
    if not div:
        lines.append("_no divergence table embedded in trace_")
    else:
        lines.extend(_divergence_markdown(div))
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.profile",
        description="Print a markdown profile report (top ops, critical "
                    "path, divergence table) for exported RIMMS traces.")
    ap.add_argument("traces", nargs="+", metavar="TRACE.json")
    ap.add_argument("--top", type=int, default=10,
                    help="rows per top-ops table (default 10)")
    args = ap.parse_args(argv)
    status = 0
    for path in args.traces:
        try:
            with open(path) as f:
                doc = json.load(f)
            print(profile_report(doc, top=args.top, title=path))
        except (OSError, ValueError) as e:
            print(f"error: {path}: {e}", file=sys.stderr)
            status = 1
    return status


if __name__ == "__main__":
    raise SystemExit(main())
