"""Continuous telemetry: divergence, samplers, metrics export.

Four pieces, all stdlib-only (this module imports nothing from ``core``
except :mod:`repro_torch.core.trace`, so every layer may import it):

``DivergenceMonitor``
    Pairs every compute/stage span's *wall* duration with its *modeled*
    duration into per-(span kind, op, PE kind, shape bucket) wall/modeled
    ratio cells — an EMA for "what is the current correction factor" and
    a log-bucketed histogram for "how stable is it".  The table is the
    calibration substrate ROADMAP item 4 consumes: a ratio of 1.0 means
    the cost model's prior matches this machine; persist it with
    :meth:`DivergenceMonitor.save_json` and fold it back with
    :meth:`DivergenceMonitor.load_json`.  Each :class:`Runtime` owns one
    monitor; :func:`aggregate_divergence` merges every monitor created
    since a serial mark (how ``benchmarks/run.py --metrics-dir`` scopes
    tables per bench).

``Sampler``
    A bounded-overhead background sampler over one :class:`Session`:
    per-PE occupancy and queue depth, arena used/free/pinned bytes and
    pressure counters, per-link modeled busy fraction, and per-tenant
    window occupancy + DRR deficit — written as gauges into the
    session's :class:`~repro_torch.core.trace.MetricsRegistry` and kept as a
    bounded ring of samples.  Off by default; ``period=0`` is the
    deterministic manual-tick mode tests drive.

``metrics_text`` / ``serve_metrics``
    Prometheus text-exposition rendering of a registry
    (``Session.metrics_text()``), plus an optional localhost HTTP
    endpoint serving ``/metrics``.

``slo_eval``
    Per-tenant SLO burn-rate evaluation: declare a latency objective on
    ``session.client(slo_latency_s=...)`` and ``qos_report()`` grows an
    ``slo`` section (violation rate, burn rate = budget consumption
    multiple, breached flag) with alert instants in the trace.
"""

from __future__ import annotations

import http.server
import json
import math
import re
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .trace import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "DivergenceMonitor",
    "Sampler",
    "metrics_text",
    "serve_metrics",
    "MetricsServer",
    "slo_eval",
    "shape_bucket",
    "divergence_serial",
    "aggregate_divergence",
]


# ---------------------------------------------------------------------------
# Measured-vs-modeled divergence
# ---------------------------------------------------------------------------


def _fmt_bytes(n: int) -> str:
    if n <= 0:
        return "0B"
    for unit, shift in (("GiB", 30), ("MiB", 20), ("KiB", 10)):
        if n >= (1 << shift):
            v = n / (1 << shift)
            return f"{v:g}{unit}"
    return f"{n}B"


def shape_bucket(nbytes: int) -> str:
    """Power-of-two shape bucket label for ``nbytes`` of input
    (``"<=64KiB"`` …) — coarse enough that repeated runs of one workload
    land in the same cell, fine enough that a 1 KiB and a 64 MiB FFT
    never share a correction factor."""
    n = int(nbytes)
    if n <= 0:
        return "0B"
    return "<=" + _fmt_bytes(1 << (n - 1).bit_length())


# Monitors self-register here so aggregate_divergence() can merge every
# monitor created after a serial mark (per-bench scoping).  References
# are strong but bounded: a monitor holds only its ratio cells (no
# back-reference to its runtime), and the registry keeps at most
# _DIV_KEEP recent monitors — benches aggregate right after their run,
# long processes (test suites) shed the old ones.
_DIV_KEEP = 512
_div_lock = threading.Lock()
_div_serial = 0
_div_monitors: Dict[int, "DivergenceMonitor"] = {}


def divergence_serial() -> int:
    """High-water serial of created monitors — capture before a run,
    pass to :func:`aggregate_divergence` after to scope the merge."""
    with _div_lock:
        return _div_serial


def aggregate_divergence(since: int = 0) -> "DivergenceMonitor":
    """A fresh monitor holding the merged cells of every registered
    monitor with serial > ``since`` (0 = all retained monitors this
    process created)."""
    with _div_lock:
        monitors = [m for s, m in _div_monitors.items() if s > since]
    agg = DivergenceMonitor(register=False)
    for m in monitors:
        agg.merge(m.state())
    return agg


class DivergenceMonitor:
    """Wall/modeled ratio tables per (span kind, op, PE kind, shape
    bucket).

    ``observe`` is called from the runtime's compute and stage paths
    with both durations; pairs where either side is non-positive cannot
    form a ratio and are tallied as ``skipped`` instead of poisoning the
    EMA.  Thread-safe; O(1) per observation.
    """

    EMA = 0.2

    def __init__(self, *, register: bool = True) -> None:
        self._lock = threading.Lock()
        # key -> [count, skipped, wall_s, model_s, ema, Histogram]
        self._cells: Dict[Tuple[str, str, str, str], list] = {}
        if register:
            global _div_serial
            with _div_lock:
                _div_serial += 1
                self.serial = _div_serial
                _div_monitors[self.serial] = self
                while len(_div_monitors) > _DIV_KEEP:
                    _div_monitors.pop(next(iter(_div_monitors)))
        else:
            self.serial = 0

    def observe(self, kind: str, op: str, pe_kind: str, nbytes: int,
                wall_s: float, model_s: float) -> None:
        key = (kind, op, pe_kind, shape_bucket(nbytes))
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = [0, 0, 0.0, 0.0, None, Histogram("ratio")]
                self._cells[key] = cell
            if wall_s <= 0.0 or model_s <= 0.0:
                cell[1] += 1
                return
            ratio = wall_s / model_s
            cell[0] += 1
            cell[2] += wall_s
            cell[3] += model_s
            cell[4] = (ratio if cell[4] is None
                       else (1 - self.EMA) * cell[4] + self.EMA * ratio)
            cell[5].record(ratio)

    @staticmethod
    def key_str(key: Tuple[str, str, str, str]) -> str:
        return "/".join(key)

    def table(self) -> Dict[str, dict]:
        """The ratio table: ``"kind/op/pe_kind/bucket"`` → stats.  Every
        row with ``count > 0`` has a finite positive ``ema_ratio``."""
        with self._lock:
            items = sorted(self._cells.items())
        out: Dict[str, dict] = {}
        for key, (count, skipped, wall_s, model_s, ema, hist) in items:
            out[self.key_str(key)] = {
                "kind": key[0], "op": key[1], "pe_kind": key[2],
                "bucket": key[3],
                "count": count, "skipped": skipped,
                "wall_s": wall_s, "model_s": model_s,
                "ema_ratio": ema,
                "mean_ratio": hist.mean if count else None,
                "p50_ratio": hist.percentile(50),
                "p95_ratio": hist.percentile(95),
            }
        return out

    # -- persistence / merge ------------------------------------------------

    def state(self) -> dict:
        """JSON-safe full state (bucket-exact; mergeable)."""
        with self._lock:
            items = sorted(self._cells.items())
        return {
            "cells": {
                self.key_str(k): {
                    "count": c[0], "skipped": c[1],
                    "wall_s": c[2], "model_s": c[3], "ema": c[4],
                    "hist": c[5].to_state(),
                }
                for k, c in items
            }
        }

    def merge(self, state: dict) -> "DivergenceMonitor":
        """Fold a ``state()`` dict into this monitor.  Counts, sums and
        histograms merge exactly; the EMA takes a count-weighted blend
        (order across monitors is not recoverable, nor meaningful)."""
        for key_s, c in (state.get("cells") or {}).items():
            parts = tuple(key_s.split("/"))
            if len(parts) != 4:
                continue
            with self._lock:
                cell = self._cells.get(parts)
                if cell is None:
                    cell = [0, 0, 0.0, 0.0, None, Histogram("ratio")]
                    self._cells[parts] = cell
                n_old, n_new = cell[0], int(c.get("count", 0))
                cell[0] = n_old + n_new
                cell[1] += int(c.get("skipped", 0))
                cell[2] += float(c.get("wall_s", 0.0))
                cell[3] += float(c.get("model_s", 0.0))
                ema_new = c.get("ema")
                if ema_new is not None:
                    if cell[4] is None or n_old + n_new == 0:
                        cell[4] = ema_new
                    else:
                        cell[4] = ((n_old * cell[4] + n_new * ema_new)
                                   / (n_old + n_new))
                cell[5].merge(c.get("hist", {}))
        return self

    def save_json(self, path: str) -> None:
        """.. deprecated::
           Raw divergence-JSON plumbing is superseded by the calibration
           table (``Session.save_calibration(path)`` embeds the same
           divergence snapshot in a "rimms-calib-v1" file).  One
           :class:`DeprecationWarning` per process."""
        _warn_divergence_json("save_json",
                              "Session.save_calibration(path)")
        with open(path, "w") as fh:
            json.dump({"format": "rimms-divergence-v1",
                       "state": self.state(), "table": self.table()},
                      fh, indent=1, sort_keys=True)

    @classmethod
    def load_json(cls, path: str) -> "DivergenceMonitor":
        """.. deprecated::
           Load through ``Session(calibration=path)`` instead — a
           calibration table's embedded divergence snapshot merges into
           the runtime's live monitor at construction."""
        _warn_divergence_json("load_json", "Session(calibration=path)")
        with open(path) as fh:
            doc = json.load(fh)
        mon = cls(register=False)
        mon.merge(doc.get("state", doc))
        return mon


# One DeprecationWarning per process (same pattern as the
# Runtime.run/run_graph deprecation): the first raw divergence-JSON call
# warns, later ones stay quiet.
_divergence_json_warned = False


def _warn_divergence_json(which: str, instead: str) -> None:
    global _divergence_json_warned
    if _divergence_json_warned:
        return
    _divergence_json_warned = True
    warnings.warn(
        f"DivergenceMonitor.{which}() raw divergence-JSON plumbing is "
        f"deprecated; use the calibration-table entry point instead "
        f"({instead} — 'rimms-calib-v1' files embed the divergence "
        f"snapshot).",
        DeprecationWarning,
        stacklevel=3,
    )


# ---------------------------------------------------------------------------
# Background sampler
# ---------------------------------------------------------------------------


class Sampler:
    """Gauge time-series sampler over one :class:`Session`.

    ``period > 0`` runs a daemon thread waking every ``period`` seconds;
    ``period == 0`` (default) takes samples only on explicit
    :meth:`tick` calls — the deterministic mode tests use.  Each tick
    writes current gauges into ``session.metrics`` and appends one
    sample dict to the bounded :attr:`samples` ring.  The work per tick
    is O(PEs + arenas + links + tenants) dictionary reads — no kernel
    path is touched, so overhead is bounded by the period, not the task
    rate (gated in ``bench_overhead.py``).
    """

    def __init__(self, session, *, period: float = 0.0,
                 max_samples: int = 4096) -> None:
        if period < 0:
            raise ValueError(f"sampler period must be >= 0, got {period}")
        if max_samples <= 0:
            raise ValueError("sampler max_samples must be > 0")
        self.session = session
        self.period = float(period)
        self.samples: deque = deque(maxlen=int(max_samples))
        self.ticks = 0
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._last_link: Optional[Tuple[float, Dict[str, float]]] = None
        self._lock = threading.Lock()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Sampler":
        """Start the background thread (no-op in manual-tick mode or if
        already running/stopped)."""
        if self._stopped or self.period <= 0 or self.running:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="rimms-sampler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self.tick()
            except Exception:  # pragma: no cover - sampling must not kill
                pass

    def stop(self) -> None:
        """Stop permanently: the thread exits and further ticks (manual
        included) become no-ops — a closed session takes no samples."""
        self._stopped = True
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def tick(self) -> Optional[dict]:
        """Take one sample now; returns the sample dict (None after
        :meth:`stop`)."""
        if self._stopped:
            return None
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> dict:
        session = self.session
        metrics = session.metrics
        now = time.perf_counter()
        gauges: Dict[str, float] = {}

        def put(name: str, value: float) -> None:
            gauges[name] = float(value)
            metrics.gauge(name).set(value)

        # per-PE queue depth + busy flag (worker pool, when running)
        pool = getattr(session.runtime, "_worker_pool", None)
        if pool is not None and not pool.closed:
            for pe_name in pool.pe_names:
                put(f"pe_queue_depth/{pe_name}",
                    pool.queues[pe_name].qsize())
                put(f"pe_busy/{pe_name}",
                    1.0 if pool.active.get(pe_name) else 0.0)

        # arena used/free/pinned bytes per device space
        ctx = session.context
        with ctx._arena_lock:
            spaces = [(loc, sp) for loc, sp in ctx.spaces.items()
                      if sp.arena is not None]
            for loc, sp in spaces:
                label = str(loc)
                free = sp.arena.free_bytes
                put(f"arena_free_bytes/{label}", free)
                put(f"arena_used_bytes/{label}", sp.arena.capacity - free)
                put(f"arena_pinned_bytes/{label}",
                    sum(hd.nbytes for hd in sp.residents.values()
                        if hd.pin_count(loc) > 0))

        # pressure counters (cumulative, exported as gauges so the ring
        # holds a time series CI and dashboards can difference)
        led = ctx.ledger
        put("pressure_evictions", led.total_evictions)
        put("pressure_spill_stalls", led.n_spill_stalls)
        put("pressure_prefetch_deferrals", led.prefetch_deferrals)

        # per-link modeled busy seconds + busy fraction since last tick
        per_link = led.per_link_summary()
        link_s = {link: row["modeled_s"] for link, row in per_link.items()}
        prev = self._last_link
        for link, total_s in sorted(link_s.items()):
            put(f"link_modeled_busy_s/{link}", total_s)
            frac = 0.0
            if prev is not None:
                dt = now - prev[0]
                if dt > 0:
                    frac = max(0.0, total_s - prev[1].get(link, 0.0)) / dt
            put(f"link_busy_fraction/{link}", frac)
        self._last_link = (now, link_s)

        # per-tenant window occupancy + DRR deficit
        snap = session.qos.snapshot()
        for name, c in sorted(snap.get("clients", {}).items()):
            window = max(1, c.get("window", 1))
            put(f"tenant_window_occupancy/{name}",
                c.get("inflight", 0) / window)
            put(f"tenant_drr_deficit/{name}", c.get("deficit", 0.0))

        self.ticks += 1
        sample = {"seq": self.ticks, "t": now - self._t0, "gauges": gauges}
        self.samples.append(sample)
        return sample


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_ESC = str.maketrans({"\\": r"\\", '"': r"\"", "\n": r"\n"})


def _metric_name(base: str, prefix: str) -> str:
    name = _NAME_RE.sub("_", base)
    if prefix:
        name = f"{prefix}_{name}"
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _labels(key: Optional[str], extra: str = "") -> str:
    parts = []
    if key:
        parts.append(f'key="{key.translate(_LABEL_ESC)}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def metrics_text(registry: MetricsRegistry, *, prefix: str = "rimms") -> str:
    """Render ``registry`` in the Prometheus text exposition format
    (version 0.0.4).  A metric named ``"base/key"`` becomes family
    ``{prefix}_{base}`` with label ``key="key"``; counters gain the
    conventional ``_total`` suffix; histograms export as summaries
    (``quantile`` labels + ``_sum``/``_count``).  Deterministic output
    order (sorted families, then labels)."""
    with registry._lock:
        items = sorted(registry._instruments.items())
    families: Dict[Tuple[str, str], List[Tuple[str, Any]]] = {}
    for name, inst in items:
        base, _, key = name.partition("/")
        if isinstance(inst, Counter):
            ftype = "counter"
        elif isinstance(inst, Gauge):
            ftype = "gauge"
        elif isinstance(inst, Histogram):
            ftype = "summary"
        else:  # pragma: no cover - unknown instrument kinds are skipped
            continue
        families.setdefault((base, ftype), []).append((key, inst))

    lines: List[str] = []
    for (base, ftype), members in sorted(families.items()):
        fam = _metric_name(base, prefix)
        if ftype == "counter":
            fam += "_total"
        lines.append(f"# TYPE {fam} {ftype}")
        for key, inst in members:
            if ftype == "counter":
                lines.append(f"{fam}{_labels(key)} {inst.value}")
            elif ftype == "gauge":
                lines.append(f"{fam}{_labels(key)} {_fmt_val(inst.value)}")
            else:
                snap = inst.snapshot()
                for q, field in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    v = snap[field]
                    if v is None:
                        continue
                    qlabel = 'quantile="%s"' % q
                    lines.append(
                        f"{fam}{_labels(key, qlabel)} {_fmt_val(v)}")
                lines.append(f"{fam}_sum{_labels(key)} {_fmt_val(snap['sum'])}")
                lines.append(f"{fam}_count{_labels(key)} {snap['count']}")
    return "\n".join(lines) + "\n"


def _fmt_val(v: float) -> str:
    if v != v:  # pragma: no cover - NaN guard
        return "NaN"
    if v in (math.inf, -math.inf):  # pragma: no cover
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class MetricsServer:
    """Localhost HTTP endpoint serving ``GET /metrics`` (and ``/``) in
    Prometheus text format.  Runs on a daemon thread; :meth:`close`
    shuts it down.  Obtain via :func:`serve_metrics` or
    ``Session.serve_metrics()``."""

    def __init__(self, render: Callable[[], str], host: str, port: int) -> None:
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API)
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = server._render().encode()
                except Exception as exc:  # pragma: no cover - render bug
                    self.send_error(500, str(exc))
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a: Any) -> None:  # silence stderr
                pass

        self._render = render
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="rimms-metrics-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def serve_metrics(source: Union[MetricsRegistry, Callable[[], str]],
                  *, host: str = "127.0.0.1", port: int = 0) -> MetricsServer:
    """Serve ``source`` (a registry, or a callable returning exposition
    text) over HTTP on localhost.  ``port=0`` picks a free port — read
    it back from ``server.port`` / ``server.url``."""
    if isinstance(source, MetricsRegistry):
        reg = source
        render = lambda: metrics_text(reg)  # noqa: E731
    else:
        render = source
    return MetricsServer(render, host, port)


# ---------------------------------------------------------------------------
# SLO burn-rate evaluation
# ---------------------------------------------------------------------------


def slo_eval(latencies: List[float], objective_s: float,
             target: float) -> dict:
    """Evaluate a latency SLO over one tenant's task latencies.

    ``target`` is the success objective (e.g. 0.99 = 99 % of tasks under
    ``objective_s``); the error budget is ``1 - target`` and the *burn
    rate* is the multiple of that budget the observed violation rate
    consumes — burn 1.0 exactly exhausts the budget, > 1.0 breaches."""
    if objective_s <= 0:
        raise ValueError(f"slo objective_s must be > 0, got {objective_s}")
    if not 0.0 < target < 1.0:
        raise ValueError(f"slo target must be in (0, 1), got {target}")
    tasks = len(latencies)
    violations = sum(1 for v in latencies if v > objective_s)
    rate = violations / tasks if tasks else 0.0
    budget = 1.0 - target
    burn = rate / budget
    return {
        "objective_s": float(objective_s),
        "target": float(target),
        "tasks": tasks,
        "violations": violations,
        "violation_rate": rate,
        "burn_rate": burn,
        "breached": burn > 1.0,
    }
