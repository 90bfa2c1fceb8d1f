"""Measured calibration — the runtime's last guessed constants become
measured (ROADMAP item 4).

HEFT placement and every gated modeled metric rested on
:class:`~repro_torch.core.graph.CostModel` throughput *priors*
(``BASE_THROUGHPUT``), only nudged by an online EMA.  This module closes
the loop:

* :class:`CalibrationTable` — a versioned ("rimms-calib-v1"),
  mergeable, persistable table of measured kernel timings keyed
  ``(op, variant, pe_kind, shape bucket)`` — the same power-of-two
  bucket keying the :class:`~repro_torch.core.telemetry.DivergenceMonitor`
  uses, so calibration cells and divergence cells line up.  Winner rows
  per ``(op, pe_kind, bucket)`` record which registered kernel variant
  measured fastest (autotuning, see :mod:`repro_torch.core.autotune`), and a
  table may embed a divergence-monitor state snapshot so one file
  carries both calibration and live EMA evidence
  (:meth:`~repro_torch.core.api.Session.save_calibration`).
* :func:`calibrate` — the measurement harness: microbenchmarks every
  registered ``@rimms.op`` variant per PE kind across a ladder of input
  sizes (warmup + median-of-k, waiting on the CUDA stream of every
  CUDA output), verifying every non-default variant's outputs
  are **bit-identical** to the default variant before it may win.
* :func:`heft_plan` / :func:`simulate_plan` — a deterministic static
  HEFT planner + plan evaluator over the runtime's cost basis, used by
  ``bench_calibrate`` to gate *calibrated placement ≤ prior placement*
  without wall-clock noise: plan once with the prior model, once with a
  calibrated model, and price both plans under the measured truth.

Consumption: :meth:`CostModel.prior_estimate
<repro_torch.core.graph.CostModel.prior_estimate>` consults an attached table
before falling back to ``BASE_THROUGHPUT``, so serial dispatch, the
windowed-HEFT stream placement, and the modeled replays all price work
from measured throughput; :meth:`Runtime._run_kernel
<repro_torch.core.runtime.Runtime._run_kernel>` consults the table's winner
rows to dispatch the fastest bit-identical kernel variant.
"""

from __future__ import annotations

import json
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .graph import build_graph
from .runtime import sync_cuda
from .telemetry import shape_bucket

__all__ = [
    "FORMAT", "DEFAULT_VARIANT", "DEFAULT_LADDER", "CalibrationTable",
    "calibrate", "resolve_calibration", "heft_plan", "simulate_plan",
]

#: on-disk format tag — bump on incompatible cell/winner layout changes
FORMAT = "rimms-calib-v1"

#: name of the reference variant every op has (the plain registration)
DEFAULT_VARIANT = "default"

#: default input-size ladder (bytes of total kernel input) — one cell
#: per power-of-two shape bucket from small to cache-busting
DEFAULT_LADDER = (64 << 10, 1 << 20, 8 << 20)


def _cell_key(op: str, variant: str, pe_kind: str, bucket: str) -> str:
    return "/".join((op, variant, pe_kind, bucket))


def _win_key(op: str, pe_kind: str, bucket: str) -> str:
    return "/".join((op, pe_kind, bucket))


def _bucket_of(nbytes_or_bucket) -> str:
    if isinstance(nbytes_or_bucket, str):
        return nbytes_or_bucket
    return shape_bucket(int(nbytes_or_bucket))


class CalibrationTable:
    """Measured per-(op, variant, PE kind, shape-bucket) kernel timings
    plus per-(op, PE kind, bucket) variant winners.

    Cells record the median measured seconds for one variant at one
    bucket (count-weighted means under :meth:`merge`, so tables from
    repeated runs — or different workers — fold together).  Winner rows
    name the variant that measured fastest with bit-identical outputs;
    ``speedup`` is default-median / winner-median (≥ 1.0 whenever a
    non-default variant wins).  ``divergence`` optionally embeds a
    :meth:`DivergenceMonitor.state()
    <repro_torch.core.telemetry.DivergenceMonitor.state>` snapshot so one file
    replaces the raw divergence-JSON plumbing.  Thread-safe.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # "op/variant/kind/bucket" -> {count, nbytes, median_s, identical}
        self._cells: Dict[str, Dict[str, Any]] = {}
        # "op/kind/bucket" -> {variant, speedup, median_s}
        self._winners: Dict[str, Dict[str, Any]] = {}
        #: optional embedded DivergenceMonitor.state() snapshot
        self.divergence: Optional[dict] = None
        #: free-form provenance (host, backend, ladder, …)
        self.meta: Dict[str, Any] = {}

    # -- recording -----------------------------------------------------------
    def record(self, op: str, variant: str, pe_kind: str, nbytes: int,
               seconds: float, *, identical: Optional[bool] = None) -> None:
        """Fold one measurement (median of a batch) into the cell for
        ``nbytes``'s shape bucket."""
        key = _cell_key(op, variant, pe_kind, shape_bucket(nbytes))
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                self._cells[key] = {
                    "count": 1, "nbytes": int(nbytes),
                    "median_s": float(seconds), "identical": identical,
                }
                return
            n = cell["count"]
            cell["median_s"] = (n * cell["median_s"] + float(seconds)) / (n + 1)
            cell["nbytes"] = int(round((n * cell["nbytes"] + nbytes) / (n + 1)))
            cell["count"] = n + 1
            if identical is not None:
                cell["identical"] = (identical if cell["identical"] is None
                                     else cell["identical"] and identical)

    def set_winner(self, op: str, pe_kind: str, nbytes_or_bucket,
                   variant: str, *, speedup: float, median_s: float) -> None:
        with self._lock:
            self._winners[_win_key(op, pe_kind,
                                   _bucket_of(nbytes_or_bucket))] = {
                "variant": variant, "speedup": float(speedup),
                "median_s": float(median_s),
            }

    # -- lookup --------------------------------------------------------------
    def cell(self, op: str, pe_kind: str, nbytes_or_bucket,
             variant: str = DEFAULT_VARIANT) -> Optional[Dict[str, Any]]:
        with self._lock:
            c = self._cells.get(_cell_key(op, variant, pe_kind,
                                          _bucket_of(nbytes_or_bucket)))
            return dict(c) if c is not None else None

    def winner(self, op: str, pe_kind: str,
               nbytes_or_bucket) -> Optional[Dict[str, Any]]:
        with self._lock:
            w = self._winners.get(_win_key(op, pe_kind,
                                           _bucket_of(nbytes_or_bucket)))
            return dict(w) if w is not None else None

    def best_variant(self, op: str, pe_kind: str, nbytes: int) -> Optional[str]:
        """The winning *non-default* variant name for this bucket, or
        None (default dispatch) — what ``Runtime._run_kernel`` asks."""
        w = self.winner(op, pe_kind, nbytes)
        if w is None or w["variant"] == DEFAULT_VARIANT:
            return None
        return w["variant"]

    def estimate_s(self, op: str, pe_kind: str, nbytes: int, *,
                   launch_s: float = 0.0) -> Optional[float]:
        """Measured compute-seconds estimate for ``nbytes`` of input, or
        None when this exact ``(op, pe_kind, bucket)`` has no cell (the
        cost model then falls back to its throughput prior).  Uses the
        bucket's winner cell when present, else the default variant's;
        scales by measured seconds-per-byte around ``launch_s``."""
        bucket = shape_bucket(nbytes)
        w = self.winner(op, pe_kind, bucket)
        cell = None
        if w is not None:
            cell = self.cell(op, pe_kind, bucket, w["variant"])
        if cell is None:
            cell = self.cell(op, pe_kind, bucket)
        if cell is None:
            return None
        ref_bytes = cell["nbytes"]
        if ref_bytes <= 0:
            return cell["median_s"]
        per_byte = max(cell["median_s"] - launch_s, 0.0) / ref_bytes
        return launch_s + nbytes * per_byte

    def cells(self) -> List[Tuple[str, Dict[str, Any]]]:
        with self._lock:
            return sorted((k, dict(v)) for k, v in self._cells.items())

    def winners(self) -> List[Tuple[str, Dict[str, Any]]]:
        with self._lock:
            return sorted((k, dict(v)) for k, v in self._winners.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._cells)

    # -- persistence / merge -------------------------------------------------
    def state(self) -> dict:
        """JSON-safe full state (mergeable via :meth:`merge`)."""
        with self._lock:
            return {
                "format": FORMAT,
                "meta": dict(self.meta),
                "cells": {k: dict(v) for k, v in sorted(self._cells.items())},
                "winners": {k: dict(v)
                            for k, v in sorted(self._winners.items())},
                "divergence": self.divergence,
            }

    def merge(self, other: "CalibrationTable | dict") -> "CalibrationTable":
        """Fold another table (or its :meth:`state` dict) into this one:
        cells take count-weighted means, a winner row is replaced only by
        a strictly faster one, divergence snapshots merge exactly."""
        state = other.state() if isinstance(other, CalibrationTable) else other
        for key, c in (state.get("cells") or {}).items():
            if len(key.split("/")) != 4:
                continue
            with self._lock:
                mine = self._cells.get(key)
                if mine is None:
                    self._cells[key] = {
                        "count": int(c.get("count", 1)),
                        "nbytes": int(c.get("nbytes", 0)),
                        "median_s": float(c.get("median_s", 0.0)),
                        "identical": c.get("identical"),
                    }
                else:
                    n0, n1 = mine["count"], int(c.get("count", 1))
                    tot = max(n0 + n1, 1)
                    mine["median_s"] = (n0 * mine["median_s"]
                                        + n1 * float(c.get("median_s", 0.0))
                                        ) / tot
                    mine["nbytes"] = int(round(
                        (n0 * mine["nbytes"] + n1 * int(c.get("nbytes", 0)))
                        / tot))
                    mine["count"] = n0 + n1
                    ident = c.get("identical")
                    if ident is not None:
                        mine["identical"] = (
                            ident if mine["identical"] is None
                            else mine["identical"] and ident)
        for key, w in (state.get("winners") or {}).items():
            with self._lock:
                mine = self._winners.get(key)
                if mine is None or float(w.get("median_s", float("inf"))) \
                        < mine["median_s"]:
                    self._winners[key] = {
                        "variant": w.get("variant", DEFAULT_VARIANT),
                        "speedup": float(w.get("speedup", 1.0)),
                        "median_s": float(w.get("median_s", 0.0)),
                    }
        div = state.get("divergence")
        if div:
            from .telemetry import DivergenceMonitor

            mon = DivergenceMonitor(register=False)
            if self.divergence:
                mon.merge(self.divergence)
            mon.merge(div)
            self.divergence = mon.state()
        for k, v in (state.get("meta") or {}).items():
            self.meta.setdefault(k, v)
        return self

    def save(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.state(), fh, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path) -> "CalibrationTable":
        with open(path) as fh:
            doc = json.load(fh)
        fmt = doc.get("format")
        if fmt != FORMAT:
            raise ValueError(
                f"{path}: not a calibration table (format {fmt!r}, "
                f"expected {FORMAT!r})")
        table = cls()
        table.merge(doc)
        table.meta.update(doc.get("meta") or {})
        return table

    # -- reporting -----------------------------------------------------------
    def diff(self, other: "CalibrationTable") -> Dict[str, dict]:
        """Cells/winners that differ between two tables (``a`` = self,
        ``b`` = other): changed medians, changed winning variants, and
        rows present on only one side."""
        out: Dict[str, dict] = {}
        a_cells, b_cells = dict(self.cells()), dict(other.cells())
        for key in sorted(set(a_cells) | set(b_cells)):
            ca, cb = a_cells.get(key), b_cells.get(key)
            if ca is None or cb is None:
                out[key] = {"a": ca and ca["median_s"],
                            "b": cb and cb["median_s"]}
            elif not np.isclose(ca["median_s"], cb["median_s"],
                                rtol=0.25, atol=1e-7):
                out[key] = {"a": ca["median_s"], "b": cb["median_s"],
                            "ratio": cb["median_s"] / max(ca["median_s"],
                                                          1e-12)}
        a_w, b_w = dict(self.winners()), dict(other.winners())
        for key in sorted(set(a_w) | set(b_w)):
            wa, wb = a_w.get(key), b_w.get(key)
            va = wa and wa["variant"]
            vb = wb and wb["variant"]
            if va != vb:
                out[f"winner:{key}"] = {"a": va, "b": vb}
        return out

    def to_markdown(self) -> str:
        """Human-readable report: winner rows first, then every cell."""
        lines = ["## Calibration table", ""]
        if self.meta:
            lines += [f"- **{k}**: {v}" for k, v in sorted(self.meta.items())]
            lines.append("")
        lines += ["### Variant winners", "",
                  "| op | PE kind | bucket | variant | speedup | median |",
                  "|---|---|---|---|---:|---:|"]
        for key, w in self.winners():
            op, kind, bucket = key.split("/", 2)
            lines.append(
                f"| {op} | {kind} | {bucket} | {w['variant']} "
                f"| {w['speedup']:.2f}x | {w['median_s'] * 1e6:.1f} µs |")
        lines += ["", "### Measured cells", "",
                  "| op | variant | PE kind | bucket | median | n | "
                  "bit-identical |",
                  "|---|---|---|---|---:|---:|---|"]
        for key, c in self.cells():
            op, variant, kind, bucket = key.split("/", 3)
            ident = {None: "—", True: "yes", False: "NO"}[c["identical"]]
            lines.append(
                f"| {op} | {variant} | {kind} | {bucket} "
                f"| {c['median_s'] * 1e6:.1f} µs | {c['count']} | {ident} |")
        if self.divergence:
            n = len(self.divergence.get("cells") or {})
            lines += ["", f"_Embedded divergence snapshot: {n} cells._"]
        return "\n".join(lines) + "\n"


def resolve_calibration(calibration) -> Optional[CalibrationTable]:
    """The ``Session(calibration=...)`` coercion: None → None, a table →
    itself, ``"auto"`` → load ``$RIMMS_CALIBRATION`` if it names an
    existing file (else an empty table that fills from this session's
    autotuning), any other str/path → :meth:`CalibrationTable.load`."""
    if calibration is None:
        return None
    if isinstance(calibration, CalibrationTable):
        return calibration
    if calibration == "auto":
        import os

        path = os.environ.get("RIMMS_CALIBRATION")
        if path and os.path.exists(path):
            return CalibrationTable.load(path)
        return CalibrationTable()
    return CalibrationTable.load(calibration)


# ---------------------------------------------------------------------------
# Measurement harness
# ---------------------------------------------------------------------------


def _host(value: Any) -> np.ndarray:
    """A host numpy view of a kernel output (a tensor on any device, or
    an array)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _identical(outs: Sequence[Any], ref: Sequence[Any]) -> bool:
    """Bit-exact output comparison (the autotuner's eligibility bar —
    a faster variant that changes even one ULP never dispatches)."""
    if len(outs) != len(ref):
        return False
    for a, b in zip(outs, ref):
        a, b = _host(a), _host(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.tobytes() != b.tobytes():
            return False
    return True


def _block(outs: tuple) -> tuple:
    sync_cuda(outs)
    return outs


def _measure_thread(fn: Callable, ins: List[Any], params: Dict[str, Any],
                    *, k: int, warmup: int) -> Tuple[float, tuple]:
    outs: tuple = ()
    for _ in range(max(warmup, 1)):
        outs = fn(ins, **params)
        if not isinstance(outs, tuple):
            outs = (outs,)
        outs = _block(outs)
    times = []
    for _ in range(max(k, 1)):
        t0 = time.perf_counter()
        o = fn(ins, **params)
        _block(o if isinstance(o, tuple) else (o,))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), outs


def calibrate(target, *, registry=None, ops: Optional[Iterable[str]] = None,
              nbytes: Sequence[int] = DEFAULT_LADDER, k: int = 5,
              warmup: int = 2, seed: int = 0,
              table: Optional[CalibrationTable] = None,
              verbose: bool = False) -> CalibrationTable:
    """Microbenchmark every registered op variant per PE kind across the
    ``nbytes`` ladder; return (or extend) a :class:`CalibrationTable`.

    ``target`` is a :class:`~repro_torch.core.api.Session` (its runtime and
    registry are used) or a bare :class:`~repro_torch.core.runtime.Runtime`
    (pass ``registry=`` explicitly, or the process-default one is used).
    Only ops with a registered input factory (``@rimms.op(...,
    calib=...)``) are measured — others are skipped and listed in
    ``table.meta["skipped_ops"]``.  Measurements run in-thread and wait
    on the CUDA stream of every CUDA output.  For a PE whose space is
    not the host, the inputs are ingested into that space once, before
    timing, so the kernel receives what dispatch would hand it.

    Winner selection per ``(op, PE kind, bucket)``: fastest variant
    whose outputs are bit-identical to the default variant's (the
    default is always eligible); ``speedup`` = default-median /
    winner-median.
    """
    rt = getattr(target, "runtime", target)
    reg = registry or getattr(target, "registry", None)
    if reg is None:
        from .api import default_registry

        reg = default_registry
    table = table if table is not None else CalibrationTable()
    table.meta.setdefault("backend", rt.backend)
    table.meta.setdefault("ladder", [int(n) for n in nbytes])
    op_filter = set(ops) if ops is not None else None
    # one representative PE per kind, deterministic (sorted by name)
    rep: Dict[str, Any] = {}
    for pe in sorted(rt.pes, key=lambda p: p.name):
        rep.setdefault(pe.kind, pe)
    skipped: List[str] = []
    for op_name in reg.ops():
        if op_filter is not None and op_name not in op_filter:
            continue
        maker = reg.input_maker(op_name)
        if maker is None:
            skipped.append(op_name)
            continue
        for kind in reg.kinds(op_name):
            pe = rep.get(kind)
            if pe is None:
                continue
            space = rt.context.spaces[pe.location]
            for nb in nbytes:
                rng = np.random.default_rng([seed, int(nb)])
                host_ins = [np.asarray(a) for a in maker(rng, int(nb))]
                nb_act = sum(a.nbytes for a in host_ins)
                ins = [space.ingest(a) for a in host_ins]
                ref_outs: Optional[tuple] = None
                measured: List[Tuple[str, float, Optional[bool]]] = []
                for vname in reg.variants(op_name, kind):
                    var = reg.variant(op_name, kind, vname)
                    median, outs = _measure_thread(
                        var.fn, ins, dict(var.params), k=k, warmup=warmup)
                    if vname == DEFAULT_VARIANT:
                        ref_outs = outs
                        ident: Optional[bool] = None
                    else:
                        ident = (_identical(outs, ref_outs)
                                 if ref_outs is not None else False)
                    table.record(op_name, vname, kind, nb_act, median,
                                 identical=ident)
                    measured.append((vname, median, ident))
                    if verbose:
                        print(f"  {op_name}/{vname}/{kind}/"
                              f"{shape_bucket(nb_act)}: "
                              f"{median * 1e6:.1f} µs"
                              + ("" if ident is None
                                 else f" identical={ident}"))
                default_s = next(m for v, m, _ in measured
                                 if v == DEFAULT_VARIANT)
                eligible = [(v, m) for v, m, ident in measured
                            if v == DEFAULT_VARIANT or ident]
                win_v, win_s = min(eligible, key=lambda x: (x[1], x[0]))
                table.set_winner(op_name, kind, nb_act, win_v,
                                 speedup=default_s / max(win_s, 1e-12),
                                 median_s=win_s)
    if skipped:
        prev = table.meta.get("skipped_ops", [])
        table.meta["skipped_ops"] = sorted(set(prev) | set(skipped))
    return table


# ---------------------------------------------------------------------------
# Deterministic static HEFT planner — the bench_calibrate gate's core
# ---------------------------------------------------------------------------


def _src_location(hd, out_loc: Dict[int, Any]):
    return out_loc.get(id(hd), hd.last_location)


def heft_plan(rt, tasks, *, cost_model=None) -> List[str]:
    """Static HEFT over ``tasks`` on ``rt``'s PEs under ``cost_model``
    (default: the runtime's): upward ranks, then earliest-finish-time
    placement in rank order.  Pure planning — nothing executes, no
    wall-clock enters, so the same inputs always produce the same plan.
    Returns the placed PE name per task (submission order)."""
    cm = cost_model or rt.cost_model
    graph = build_graph(tasks)
    bw = rt.context.ledger.bandwidth_model

    def compute_cost(task) -> float:
        kinds = sorted({pe.kind for pe in rt._eligible(task)})
        return cm.mean_estimate(task.op, kinds, task.in_bytes)

    graph.compute_ranks(compute_cost, lambda t: bw.typical(t.in_bytes))
    order = sorted(graph.nodes, key=lambda n: (-n.rank, n.index))
    pe_free: Dict[str, float] = {pe.name: 0.0 for pe in rt.pes}
    finish: Dict[int, float] = {}
    out_loc: Dict[int, Any] = {}
    placement: Dict[int, str] = {}
    for node in order:
        task = node.task
        pes = ([rt.by_name[task.pin]] if task.pin is not None
               else rt._eligible(task))
        ready = max((finish[d] for d in node.deps), default=0.0)

        def eft(pe) -> float:
            tr = sum(
                bw.seconds(_src_location(hd, out_loc), pe.location, hd.nbytes)
                for hd in task.inputs
                if _src_location(hd, out_loc) != pe.location
            )
            start = max(pe_free[pe.name], ready + tr)
            return start + cm.estimate(task.op, pe.kind, task.in_bytes)

        best = min(pes, key=lambda pe: (eft(pe), pe.name))
        f = eft(best)
        pe_free[best.name] = f
        finish[node.index] = f
        placement[node.index] = best.name
        for hd in task.outputs:
            out_loc[id(hd)] = best.location
    return [placement[i] for i in range(len(graph.nodes))]


def simulate_plan(rt, tasks, placement: Sequence[str], *,
                  cost_model=None) -> float:
    """Modeled makespan of executing ``tasks`` under a fixed
    ``placement`` (PE name per task), priced by ``cost_model`` —
    evaluate plans from *different* models under one truth model to
    compare placement quality.  Deterministic; nothing executes."""
    cm = cost_model or rt.cost_model
    graph = build_graph(tasks)
    bw = rt.context.ledger.bandwidth_model
    pe_free: Dict[str, float] = {pe.name: 0.0 for pe in rt.pes}
    finish: Dict[int, float] = {}
    out_loc: Dict[int, Any] = {}
    for node in graph.nodes:  # builder order: deps have lower indices
        task = node.task
        pe = rt.by_name[placement[node.index]]
        ready = max((finish[d] for d in node.deps), default=0.0)
        tr = sum(
            bw.seconds(_src_location(hd, out_loc), pe.location, hd.nbytes)
            for hd in task.inputs
            if _src_location(hd, out_loc) != pe.location
        )
        start = max(pe_free[pe.name], ready + tr)
        end = start + cm.estimate(task.op, pe.kind, task.in_bytes)
        pe_free[pe.name] = end
        finish[node.index] = end
        for hd in task.outputs:
            out_loc[id(hd)] = pe.location
    return max(finish.values(), default=0.0)
