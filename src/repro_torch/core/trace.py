"""Full-lifecycle runtime tracing and metrics.

Three pieces, deliberately decoupled from the rest of ``core`` (this
module imports only the stdlib, so every other layer may import it):

``TraceCollector``
    Low-overhead event collection.  Wall-clock events (spans and
    instants) go into per-thread append-only ring buffers — no locks on
    the record path, bounded memory, a drop counter when a ring fills.
    Modeled-time events are derived in bulk from ``Timeline`` objects
    pushed at sync points (end of ``Runtime.run`` / ``GraphExecutor.run``
    / ``Session.close``), so the deterministic replay timebase costs
    nothing while tasks execute.  ``export()`` writes Chrome/Perfetto
    trace-event JSON with two process groups — pid 1 "wall clock",
    pid 2 "modeled time" — and one track per PE, per interconnect link,
    and per tenant in each group.  Open the file in ui.perfetto.dev.

``MetricsRegistry``
    Named counters, gauges and HDR-style log-bucketed histograms
    (32 sub-buckets per octave => <= 2.2 % relative quantisation error
    on percentiles).  ``Session.qos_report()`` uses the histograms to
    publish per-client p50/p95/p99 modeled latency.

``trace_lint``
    A validator that treats the trace as evidence and cross-checks the
    executor against it: span well-formedness (no negative durations,
    no overlapping intervals on exclusive resource tracks), transfer
    events reconciling *exactly* with ``TransferLedger`` copies/bytes
    (conservation holds by construction — the ledger itself emits the
    trace event under its lock), and no modeled compute span starting
    before its staging spans end.  ``python -m repro_torch.core.trace f.json``
    runs it from the command line; CI uses it as a fail-fast gate.

Tracing is off by default.  Enable per session via
``Session(trace=True)``, scoped via the ``trace()`` context manager, or
process-wide via ``install_global()`` (newly created ``HeteContext``
objects auto-attach — this is how ``benchmarks/run.py --trace-dir``
traces every benchmark without touching bench internals).
"""

from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "TraceCollector",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "trace",
    "trace_lint",
    "install_global",
    "global_collector",
]

# Wall-clock events live in process group 1, modeled-time events in
# group 2, so Perfetto renders the two timebases as separate track
# groups that can be compared side by side.
WALL_PID = 1
MODEL_PID = 2

# Span categories that claim an exclusive resource (a PE's execution
# port, an interconnect link).  Intervals in these categories must not
# overlap within a track; "stage" is deliberately absent because staging
# legitimately overlaps compute (prefetch, double-buffering).
EXCLUSIVE_CATS = frozenset({"compute", "writeback", "transfer"})

_ZERO_BUCKET = -(1 << 60)  # histogram bucket index for v <= 0


class _Ring:
    """One thread's append-only event buffer (single writer, no lock)."""

    __slots__ = ("events", "capacity", "drops", "thread_name")

    def __init__(self, capacity: int, thread_name: str):
        self.events: List[tuple] = []
        self.capacity = capacity
        self.drops = 0
        self.thread_name = thread_name


class TraceCollector:
    """Collects wall + modeled events; exports Perfetto trace JSON.

    Wall events are tuples ``(ph, name, cat, track, t0, dur, args)``
    with times in seconds relative to the collector's epoch; modeled
    events use the same layout with times in modeled seconds.
    """

    def __init__(self, capacity_per_thread: int = 1 << 16):
        self.enabled = True
        self._cap = int(capacity_per_thread)
        self._t0 = time.perf_counter()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._rings: List[_Ring] = []
        self._model: List[tuple] = []  # modeled-timebase events
        self._contexts: Dict[str, Any] = {}  # label -> HeteContext
        self._baseline: Dict[str, dict] = {}  # label -> per_link at attach
        self._epoch: Dict[str, int] = {}  # label -> ledger reset epoch
        self._edges: Dict[str, List[Tuple[int, int]]] = {}  # run -> dep edges
        self._divergence: Optional[dict] = None  # wall/modeled ratio table
        self._nctx = 0
        self._nrun = 0

    # -- hot path ----------------------------------------------------------

    def _ring(self) -> _Ring:
        r = getattr(self._tls, "ring", None)
        if r is None:
            r = _Ring(self._cap, threading.current_thread().name)
            self._tls.ring = r
            with self._lock:
                self._rings.append(r)
        return r

    def instant(self, name: str, cat: str, track: str, args: Optional[dict] = None) -> None:
        """Record a wall-clock instant event (now)."""
        if not self.enabled:
            return
        r = self._ring()
        if len(r.events) < r.capacity:
            r.events.append(("i", name, cat, track, time.perf_counter() - self._t0, 0.0, args))
        else:
            r.drops += 1

    def span(
        self,
        name: str,
        cat: str,
        track: str,
        t0: float,
        t1: float,
        args: Optional[dict] = None,
    ) -> None:
        """Record a completed wall-clock span; t0/t1 are perf_counter values.
        Its length is taken between the two offsets from the trace's
        start, so that a span ending at the reading the next one starts
        at ends exactly where that one starts (see :meth:`export`)."""
        if not self.enabled:
            return
        r = self._ring()
        if len(r.events) < r.capacity:
            s0 = t0 - self._t0
            r.events.append(("X", name, cat, track, s0, (t1 - self._t0) - s0,
                             args))
        else:
            r.drops += 1

    def forward_span(
        self,
        name: str,
        cat: str,
        track: str,
        t0: float,
        t1: float,
        *,
        lo: float,
        hi: float,
        args: Optional[dict] = None,
    ) -> None:
        """Record a span measured on *another process's* clock.

        ``t0``/``t1`` are the worker's interval already shifted into this
        process's ``perf_counter`` timebase by the caller's clock-offset
        handshake; ``lo``/``hi`` bound it to the parent-observed call
        window, so handshake drift can never produce a span that starts
        before its dispatch or ends after its reply — which would violate
        the exclusive-track invariants :func:`trace_lint` checks."""
        t0 = min(max(t0, lo), hi)
        t1 = min(max(t1, t0), hi)
        self.span(name, cat, track, t0, t1, args)

    def now(self) -> float:
        """perf_counter() — the clock spans must be stamped with."""
        return time.perf_counter()

    # -- ledger hooks (called by TransferLedger under its own lock) --------

    def transfer(self, ctx: str, src: str, dst: str, nbytes: int, seconds) -> None:
        """One data movement, mirrored 1:1 from ``TransferLedger.record``."""
        if not self.enabled:
            return
        r = self._ring()
        if len(r.events) < r.capacity:
            args = {
                "ctx": ctx,
                "src": src,
                "dst": dst,
                "nbytes": int(nbytes),
                "epoch": self._epoch.get(ctx, 0),
            }
            if seconds is not None:
                args["modeled_s"] = float(seconds)
            r.events.append(
                (
                    "i",
                    "copy",
                    "transfer",
                    f"link:{src}->{dst}",
                    time.perf_counter() - self._t0,
                    0.0,
                    args,
                )
            )
        else:
            r.drops += 1

    def ledger_reset(self, ctx: str) -> None:
        """Ledger counters were zeroed: open a fresh conservation epoch."""
        epoch = self._epoch.get(ctx, 0) + 1
        self._epoch[ctx] = epoch
        self._baseline[ctx] = {}
        self.instant("ledger_reset", "ledger", f"ctx:{ctx}", {"ctx": ctx, "epoch": epoch})

    # -- registration / modeled timebase -----------------------------------

    def register_context(self, ctx) -> str:
        """Register a HeteContext; returns its trace label ("ctx0"...)."""
        with self._lock:
            label = f"ctx{self._nctx}"
            self._nctx += 1
            self._contexts[label] = ctx
        return label

    def set_ledger_baseline(self, label: str, per_link: dict) -> None:
        """Per-link counters already in the ledger when the tracer attached
        (excluded from conservation checks for the current epoch)."""
        self._baseline[label] = dict(per_link)

    def add_timeline(self, timeline, label: str = "run") -> str:
        """Derive modeled-time spans from a Timeline; returns the run label.

        Each push gets a unique run prefix ("stream0", "serial1", ...)
        so repeated runs land in distinct modeled track groups.
        """
        with self._lock:
            run = f"{label}{self._nrun}"
            self._nrun += 1
        out: List[tuple] = []
        for ev in timeline.events():
            node = getattr(ev, "node", -1)
            cs = getattr(ev, "compute_start_m", -1.0)
            if cs < ev.model_start or cs > ev.model_end:
                # Legacy event without a recorded compute start: best-effort.
                cs = min(ev.model_end, ev.model_start + ev.transfer_s + ev.spill_s)
            ce = max(cs, ev.model_end - ev.out_transfer_s)
            base = {"task": ev.task, "node": node, "pe": ev.pe}
            if cs > ev.model_start:
                out.append(
                    (
                        "X",
                        ev.task,
                        "stage",
                        f"{run}/pe:{ev.pe}:stage",
                        ev.model_start,
                        cs - ev.model_start,
                        dict(base),
                    )
                )
            cargs = dict(base)
            cargs["wall_start"] = ev.wall_start
            cargs["wall_end"] = ev.wall_end
            out.append(("X", ev.task, "compute", f"{run}/pe:{ev.pe}", cs, ce - cs, cargs))
            if ev.model_end > ce:
                out.append(
                    (
                        "X",
                        ev.task,
                        "writeback",
                        f"{run}/pe:{ev.pe}",
                        ce,
                        ev.model_end - ce,
                        dict(base),
                    )
                )
        for tx in timeline.transfers():
            out.append(
                (
                    "X",
                    tx.task,
                    "transfer",
                    f"{run}/link:{tx.link}",
                    tx.model_start,
                    tx.model_end - tx.model_start,
                    {
                        "task": tx.task,
                        "node": getattr(tx, "node", -1),
                        "nbytes": tx.nbytes,
                        "link": tx.link,
                    },
                )
            )
        with self._lock:
            self._model.extend(out)
        return run

    def add_edges(self, edges: Sequence[Tuple[int, int]], run: str) -> None:
        """Producer->consumer node-index pairs; exported as flow arrows."""
        with self._lock:
            self._edges.setdefault(run, []).extend((int(a), int(b)) for a, b in edges)

    def add_model_instant(
        self,
        name: str,
        cat: str,
        track: str,
        t: float,
        args: Optional[dict] = None,
    ) -> None:
        """Record an instant on the *modeled* timebase (e.g. an SLO alert
        at a replayed finish time).  ``t`` is in modeled seconds."""
        with self._lock:
            self._model.append(("i", name, cat, track, float(t), 0.0, args))

    def set_divergence(self, table: Optional[dict]) -> None:
        """Attach a wall/modeled divergence table (``DivergenceMonitor
        .table()``); embedded under ``rimms.divergence`` on export so the
        profile CLI can render it without re-deriving pairings."""
        with self._lock:
            self._divergence = table

    def add_tenant_spans(self, spans: Sequence[tuple], run: str) -> None:
        """Modeled per-tenant residency: (client, t0, t1, name, node)."""
        out = []
        for client, t0, t1, name, node in spans:
            out.append(
                (
                    "X",
                    name,
                    "admitted",
                    f"{run}/tenant:{client}",
                    float(t0),
                    max(0.0, float(t1) - float(t0)),
                    {"task": name, "node": int(node), "client": client},
                )
            )
        with self._lock:
            self._model.extend(out)

    # -- introspection ------------------------------------------------------

    def drops(self) -> int:
        with self._lock:
            return sum(r.drops for r in self._rings)

    def event_count(self) -> int:
        with self._lock:
            return sum(len(r.events) for r in self._rings) + len(self._model)

    def wall_events(self) -> List[tuple]:
        """Snapshot of all wall events (testing / debugging)."""
        with self._lock:
            rings = list(self._rings)
        out: List[tuple] = []
        for r in rings:
            out.extend(r.events)
        return out

    def pause(self) -> None:
        self.enabled = False

    def resume(self) -> None:
        self.enabled = True

    # -- export -------------------------------------------------------------

    @staticmethod
    def _track_key(track: str) -> tuple:
        run, _, name = track.rpartition("/")
        if name.startswith("tenant:"):
            grp = 0
        elif name.startswith("pe:") and not name.endswith(":stage"):
            grp = 1
        elif name.endswith(":stage"):
            grp = 2
        elif name.startswith("link:"):
            grp = 3
        else:
            grp = 4
        return (run, grp, name)

    def export(self, path=None) -> dict:
        """Assemble the Perfetto trace dict; write JSON if ``path`` given.

        Call at a sync point (session closed / runtime idle) — the wall
        rings are snapshotted, not locked against concurrent writers.
        """
        with self._lock:
            rings = list(self._rings)
            model = list(self._model)
            edges = {k: list(v) for k, v in self._edges.items()}
            contexts = dict(self._contexts)
            baseline = {k: dict(v) for k, v in self._baseline.items()}
            epochs = dict(self._epoch)
            divergence = self._divergence
        wall: List[tuple] = []
        for r in rings:
            wall.extend(list(r.events))

        raw: List[tuple] = []  # (pid, ph, name, cat, track, ts_us, dur_us, args)
        for ph, name, cat, track, t0, dur, args in wall:
            # a wall span's end from its end offset, not ts + dur * 1e6:
            # late in a trace the two round apart by more than the
            # lint's tolerance, and abutting spans would overlap
            ts = t0 * 1e6
            raw.append((WALL_PID, ph, name, cat, track, ts,
                        (t0 + dur) * 1e6 - ts, args))
        for ph, name, cat, track, t0, dur, args in model:
            raw.append((MODEL_PID, ph, name, cat, track, t0 * 1e6, dur * 1e6, args))

        tracks = sorted({(pid, tr) for pid, _, _, _, tr, _, _, _ in raw})
        tracks.sort(key=lambda pt: (pt[0],) + self._track_key(pt[1]))
        tid_of = {pt: i + 1 for i, pt in enumerate(tracks)}

        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": WALL_PID, "tid": 0,
             "args": {"name": "wall clock"}},
            {"ph": "M", "name": "process_sort_index", "pid": WALL_PID, "tid": 0,
             "args": {"sort_index": 1}},
            {"ph": "M", "name": "process_name", "pid": MODEL_PID, "tid": 0,
             "args": {"name": "modeled time"}},
            {"ph": "M", "name": "process_sort_index", "pid": MODEL_PID, "tid": 0,
             "args": {"sort_index": 2}},
        ]
        for (pid, track), tid in tid_of.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": track}})
            events.append({"ph": "M", "name": "thread_sort_index", "pid": pid, "tid": tid,
                           "args": {"sort_index": tid}})

        for pid, ph, name, cat, track, ts, dur, args in raw:
            ev = {"ph": ph, "name": name, "cat": cat, "pid": pid,
                  "tid": tid_of[(pid, track)], "ts": ts}
            if ph == "X":
                ev["dur"] = dur
            else:
                ev["s"] = "t"
            if args:
                ev["args"] = args
            events.append(ev)

        # Causal flow links: producer compute end -> consumer compute start.
        compute_at: Dict[Tuple[str, int], Tuple[int, float, float]] = {}
        for pid, ph, name, cat, track, ts, dur, args in raw:
            if pid != MODEL_PID or cat != "compute" or not args:
                continue
            node = args.get("node", -1)
            if node is None or node < 0:
                continue
            run = track.rpartition("/")[0]
            compute_at[(run, node)] = (tid_of[(pid, track)], ts, dur)
        fid = 0
        for run, pairs in edges.items():
            for src, dst in pairs:
                p = compute_at.get((run, src))
                c = compute_at.get((run, dst))
                if p is None or c is None:
                    continue
                fid += 1
                s_ts = p[1] + max(p[2] - 0.001, p[2] * 0.5)
                f_ts = c[1] + min(0.001, c[2] * 0.5)
                events.append({"ph": "s", "id": fid, "name": "dep", "cat": "flow",
                               "pid": MODEL_PID, "tid": p[0], "ts": s_ts})
                events.append({"ph": "f", "bp": "e", "id": fid, "name": "dep",
                               "cat": "flow", "pid": MODEL_PID, "tid": c[0], "ts": f_ts})

        ledgers = {}
        for label, ctx in contexts.items():
            led = getattr(ctx, "ledger", None)
            if led is None:
                continue
            ledgers[label] = {
                "per_link": led.per_link_summary(),
                "bytes_moved": led.total_bytes,
            }
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "rimms": {
                "ledgers": ledgers,
                "baselines": baseline,
                "epochs": epochs,
                "drops": sum(r.drops for r in rings),
                "capacity_per_thread": self._cap,
                "n_wall_events": len(wall),
                "n_model_events": len(model),
            },
        }
        if divergence is not None:
            doc["rimms"]["divergence"] = divergence
        if path is not None:
            with open(path, "w") as fh:
                json.dump(doc, fh)
        return doc


# ---------------------------------------------------------------------------
# Global installation + context-manager enablement
# ---------------------------------------------------------------------------

_global: Optional[TraceCollector] = None


def install_global(collector: Optional[TraceCollector]) -> None:
    """Install a process-global collector (or None to uninstall).

    ``HeteContext`` instances created while one is installed attach to
    it automatically — used by ``benchmarks/run.py --trace-dir`` to
    trace whole benchmarks without touching their internals.
    """
    global _global
    _global = collector


def global_collector() -> Optional[TraceCollector]:
    return _global


@contextlib.contextmanager
def trace(context=None, *, capacity_per_thread: int = 1 << 16, collector=None):
    """Enable tracing for the dynamic extent of a ``with`` block.

    With ``context=``, attaches to that ``HeteContext`` (and detaches on
    exit); without, installs a process-global collector so every context
    created inside the block is traced.  Yields the ``TraceCollector``.
    """
    tc = collector if collector is not None else TraceCollector(capacity_per_thread)
    if context is not None:
        context.set_tracer(tc)
        try:
            yield tc
        finally:
            context.set_tracer(None)
    else:
        prev = _global
        install_global(tc)
        try:
            yield tc
        finally:
            install_global(prev)


# ---------------------------------------------------------------------------
# Metrics: counters, gauges, log-bucketed histograms
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str = ""):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._v}


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str = ""):
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._v}


class Histogram:
    """HDR-style log-bucketed histogram.

    Values land in buckets of constant *relative* width: 32 sub-buckets
    per power of two, i.e. bucket edges at ``2**(i/32)``, bounding the
    quantisation error of any reported percentile at 2^(1/32)-1 < 2.2 %.
    Non-positive values share a single zero bucket.  Memory is O(octaves
    covered * 32), independent of sample count.
    """

    SUBBUCKETS = 32

    __slots__ = ("name", "count", "sum", "min", "max", "_counts", "_lock")

    def __init__(self, name: str = ""):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._counts: Dict[int, int] = {}
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        v = float(value)
        idx = _ZERO_BUCKET if v <= 0.0 else math.floor(math.log2(v) * self.SUBBUCKETS)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._counts[idx] = self._counts.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> Optional[float]:
        """Value at the q-th percentile, accurate to the bucket width.

        Returns ``None`` for an empty histogram — callers must not
        confuse "no samples" with "all samples were zero".
        """
        with self._lock:
            return self.percentile_unlocked(q)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "type": "histogram",
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.percentile_unlocked(50),
                "p95": self.percentile_unlocked(95),
                "p99": self.percentile_unlocked(99),
            }

    # snapshot() holds the lock; percentile() would deadlock on re-entry.
    def percentile_unlocked(self, q: float) -> Optional[float]:
        if self.count == 0:
            return None
        rank = max(1, math.ceil(self.count * q / 100.0))
        cum = 0
        for idx in sorted(self._counts):
            cum += self._counts[idx]
            if cum >= rank:
                if idx == _ZERO_BUCKET:
                    return 0.0
                hi = 2.0 ** ((idx + 1) / self.SUBBUCKETS)
                return min(max(hi, self.min), self.max)
        return self.max

    # -- state transfer / merge (cross-process aggregation) -------

    def to_state(self) -> dict:
        """Picklable/JSON-safe snapshot of the full bucket state."""
        with self._lock:
            return {
                "name": self.name,
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "counts": {str(k): v for k, v in self._counts.items()},
            }

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        h = cls(state.get("name", ""))
        h.merge(state)
        return h

    def merge(self, other: Union["Histogram", dict]) -> "Histogram":
        """Fold ``other`` (a Histogram or a ``to_state()`` dict) into this
        one.  Exact on counts/sum/min/max and bucket-exact on percentiles
        — merging is associative and commutative because buckets are
        fixed by value, not by sample order."""
        state = other.to_state() if isinstance(other, Histogram) else other
        counts = state.get("counts", {})
        with self._lock:
            self.count += int(state.get("count", 0))
            self.sum += float(state.get("sum", 0.0))
            o_min, o_max = state.get("min"), state.get("max")
            if o_min is not None and o_min < self.min:
                self.min = float(o_min)
            if o_max is not None and o_max > self.max:
                self.max = float(o_max)
            for k, v in counts.items():
                idx = int(k)
                self._counts[idx] = self._counts.get(idx, 0) + int(v)
        return self


class MetricsRegistry:
    """Named instruments; create-or-get semantics, snapshot for export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name!r} already registered as {type(inst).__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def histograms(self) -> List[Tuple[str, Histogram]]:
        with self._lock:
            return sorted(
                (n, i) for n, i in self._instruments.items() if isinstance(i, Histogram)
            )

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._instruments.items())
        return {name: inst.snapshot() for name, inst in sorted(items)}

    # -- cross-process aggregation --------------------------------

    def state(self) -> dict:
        """Picklable, mergeable registry state.  Counters travel as their
        totals and histograms as full bucket states; gauges are
        point-in-time local readings and deliberately do not transfer."""
        with self._lock:
            items = list(self._instruments.items())
        counters = {n: i.value for n, i in items if isinstance(i, Counter)}
        hists = {n: i.to_state() for n, i in items if isinstance(i, Histogram)}
        return {"counters": counters, "histograms": hists}

    def merge_state(self, state: dict) -> None:
        """Fold a ``state()`` dict (e.g. shipped back from a process-backend
        worker at run end) into this registry."""
        for name, v in sorted((state.get("counters") or {}).items()):
            self.counter(name).inc(int(v))
        for name, hs in sorted((state.get("histograms") or {}).items()):
            self.histogram(name).merge(hs)


# ---------------------------------------------------------------------------
# trace_lint: the trace as a correctness cross-check
# ---------------------------------------------------------------------------


def _load(trace_or_path: Union[dict, str]) -> dict:
    if isinstance(trace_or_path, dict):
        return trace_or_path
    with open(trace_or_path) as fh:
        return json.load(fh)


def trace_lint(trace_or_path: Union[dict, str], eps: float = 1e-9) -> List[str]:
    """Validate a Perfetto trace dict (or JSON file path).

    Returns a list of violation strings (empty == clean):

    1. well-formedness — every complete span has ``dur >= 0``;
    2. exclusivity — spans on exclusive resource tracks (categories
       ``compute``/``writeback``/``transfer``) never overlap within a
       track (``eps`` microseconds of float tolerance);
    3. conservation — wall transfer events in the current ledger epoch
       sum *exactly* (count and bytes per link) to the embedded
       ``TransferLedger`` per-link counters, net of the pre-attach
       baseline;
    4. causality — no modeled compute span starts before its own
       staging/transfer spans end (matched by (run, node));
    5. completeness — the ring buffers dropped nothing;
    6. worker forwarding — wall spans forwarded from process-backend
       workers (tracks ending ``:worker``) carry ``args.backend ==
       "process"`` and nest inside a compute span on the parent PE
       track; a worker span with no enclosing parent compute window is
       an orphan.
    """
    doc = _load(trace_or_path)
    violations: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    meta = doc.get("rimms", {})

    spans = [e for e in events if e.get("ph") == "X"]

    # 1. well-formedness
    for e in spans:
        if e.get("dur", 0) < 0:
            violations.append(
                f"negative duration: {e.get('name')} on tid {e.get('tid')} dur={e.get('dur')}"
            )

    # 2. per-track exclusivity for resource categories
    by_track: Dict[Tuple[int, int], List[dict]] = {}
    for e in spans:
        if e.get("cat") in EXCLUSIVE_CATS:
            by_track.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    names = {
        (e.get("pid"), e.get("tid")): e.get("args", {}).get("name", "?")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    for key, evs in by_track.items():
        evs.sort(key=lambda e: (e["ts"], e["ts"] + e.get("dur", 0)))
        prev_end = -math.inf
        prev_name = ""
        for e in evs:
            if e["ts"] < prev_end - eps:
                violations.append(
                    f"overlap on track {names.get(key, key)!r}: "
                    f"{e.get('name')} starts at {e['ts']:.3f}us before "
                    f"{prev_name} ends at {prev_end:.3f}us"
                )
            prev_end = max(prev_end, e["ts"] + e.get("dur", 0))
            prev_name = e.get("name", "")

    # 3. conservation vs TransferLedger, per context, current epoch only
    ledgers = meta.get("ledgers", {})
    baselines = meta.get("baselines", {})
    epochs = meta.get("epochs", {})
    traced: Dict[str, Dict[str, List[int]]] = {}  # ctx -> link -> [count, bytes]
    for e in events:
        if e.get("ph") != "i" or e.get("cat") != "transfer":
            continue
        args = e.get("args", {})
        ctx = args.get("ctx")
        if ctx is None or ctx not in ledgers:
            continue
        if args.get("epoch", 0) != epochs.get(ctx, 0):
            continue
        link = f"{args.get('src')}->{args.get('dst')}"
        cell = traced.setdefault(ctx, {}).setdefault(link, [0, 0])
        cell[0] += 1
        cell[1] += int(args.get("nbytes", 0))
    for ctx, led in ledgers.items():
        base = baselines.get(ctx, {})
        got = traced.get(ctx, {})
        links = set(led.get("per_link", {})) | set(got) | set(base)
        for link in sorted(links):
            want = led.get("per_link", {}).get(link, {})
            b = base.get(link, {})
            want_copies = want.get("copies", 0) - b.get("copies", 0)
            want_bytes = want.get("bytes", 0) - b.get("bytes", 0)
            have_copies, have_bytes = got.get(link, [0, 0])
            if have_copies != want_copies or have_bytes != want_bytes:
                violations.append(
                    f"conservation: ctx {ctx} link {link} traced "
                    f"{have_copies} copies/{have_bytes} B but ledger has "
                    f"{want_copies} copies/{want_bytes} B"
                )

    # 4. modeled causality: compute never starts before its staging ends
    compute_start: Dict[Tuple[str, int], float] = {}
    tid_track = {k: v for k, v in names.items()}
    for e in spans:
        track = tid_track.get((e.get("pid"), e.get("tid")), "")
        if e.get("pid") != MODEL_PID:
            continue
        node = e.get("args", {}).get("node", -1)
        if node is None or node < 0:
            continue
        run = track.rpartition("/")[0]
        if e.get("cat") == "compute":
            key = (run, node)
            if key not in compute_start or e["ts"] < compute_start[key]:
                compute_start[key] = e["ts"]
    for e in spans:
        if e.get("pid") != MODEL_PID or e.get("cat") not in ("stage", "transfer"):
            continue
        node = e.get("args", {}).get("node", -1)
        if node is None or node < 0:
            continue
        track = tid_track.get((e.get("pid"), e.get("tid")), "")
        run = track.rpartition("/")[0]
        cs = compute_start.get((run, node))
        if cs is not None and cs + eps < e["ts"] + e.get("dur", 0):
            violations.append(
                f"causality: node {node} ({e.get('name')}) compute starts at "
                f"{cs:.3f}us before its {e.get('cat')} ends at "
                f"{e['ts'] + e.get('dur', 0):.3f}us (run {run or 'wall'!r})"
            )

    # 6. process-backend worker forwarding: every wall span on a
    # ":worker" track must be tagged backend=process and sit inside a
    # compute span on its parent PE track (forward_span clamps to the
    # parent-observed call window, so true forwards always nest; an
    # orphan means a span was forged or mis-clamped).
    worker_eps = max(eps, 1e-3)  # us; forwarded spans are clamped, allow 1 ns
    parent_computes: Dict[str, List[Tuple[float, float]]] = {}
    for e in spans:
        if e.get("pid") != WALL_PID or e.get("cat") != "compute":
            continue
        track = tid_track.get((e.get("pid"), e.get("tid")), "")
        if track.endswith(":worker"):
            continue
        parent_computes.setdefault(track, []).append(
            (e["ts"], e["ts"] + e.get("dur", 0))
        )
    for e in spans:
        if e.get("pid") != WALL_PID:
            continue
        track = tid_track.get((e.get("pid"), e.get("tid")), "")
        if not track.endswith(":worker"):
            continue
        name = e.get("name", "?")
        if e.get("args", {}).get("backend") != "process":
            violations.append(
                f"worker span {name!r} on track {track!r} missing "
                f"args.backend='process'"
            )
        t0, t1 = e["ts"], e["ts"] + e.get("dur", 0)
        windows = parent_computes.get(track[: -len(":worker")], [])
        if not any(w0 - worker_eps <= t0 and t1 <= w1 + worker_eps for w0, w1 in windows):
            violations.append(
                f"orphaned worker span {name!r} on track {track!r}: "
                f"[{t0:.3f}, {t1:.3f}]us not nested in any parent compute span"
            )

    # 5. completeness
    drops = meta.get("drops", 0)
    if drops:
        violations.append(
            f"incomplete trace: {drops} events dropped "
            f"(raise capacity_per_thread, currently {meta.get('capacity_per_thread')})"
        )
    return violations


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.trace",
        description="Lint RIMMS Perfetto traces against runtime invariants.",
    )
    ap.add_argument("paths", nargs="+", help="trace JSON files to validate")
    ns = ap.parse_args(argv)
    failures = 0
    for p in ns.paths:
        try:
            violations = trace_lint(p)
        except (OSError, json.JSONDecodeError) as exc:
            violations = [f"unreadable: {exc}"]
        if violations:
            failures += 1
            print(f"FAIL {p}")
            for v in violations:
                print(f"  - {v}")
        else:
            doc = _load(p)
            meta = doc.get("rimms", {})
            print(
                f"OK   {p} ({meta.get('n_wall_events', '?')} wall + "
                f"{meta.get('n_model_events', '?')} modeled events)"
            )
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(_main())
