"""Transfer instrumentation — the evidence layer for the paper's claims.

Every copy the runtime performs (host→PE, PE→PE, PE→host) is recorded in
a :class:`TransferLedger`.  The paper's headline results are *eliminated
copies* (Fig 1, Fig 5: CPU-ACC saves 1 copy, ACC-ACC saves 3) — with the
ledger we can assert those counts exactly, and additionally integrate a
modeled transfer time under configurable link bandwidths.

Both :class:`TransferLedger` and :class:`Timeline` are thread-safe: the
graph executor (:mod:`repro_torch.core.executor`) records from one worker
thread per PE plus a transfer pool concurrently.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import Counter
from typing import Iterator, List, Optional

from .locations import DEFAULT_BANDWIDTH_MODEL, BandwidthModel, Location

__all__ = ["TransferLedger", "ledger", "Timer", "Timeline", "TimelineEvent",
           "TransferEvent", "jain_index"]


def jain_index(values) -> float:
    """Jain's fairness index over a sequence of non-negative allocations:
    ``(Σx)² / (n·Σx²)`` — 1.0 means perfectly equal, 1/n means one
    participant got everything.  Empty or all-zero input is vacuously
    fair (1.0)."""
    vals = [float(v) for v in values]
    if not vals:
        return 1.0
    sq = sum(v * v for v in vals)
    if sq == 0.0:
        return 1.0
    total = sum(vals)
    return (total * total) / (len(vals) * sq)


@dataclasses.dataclass
class TransferLedger:
    """Counts copies and bytes per (src, dst) pair + modeled seconds.

    Capacity-pressure counters: every eviction a
    :class:`~repro_torch.core.hete.HeteContext` performs under arena pressure is
    recorded here — how many, how many bytes were dirty (written back to
    host through the coherence paths; those copies also appear in
    :attr:`copies` as ``loc->host``), and how much modeled time staging
    paths stalled on eviction write-backs (spill stalls).
    """

    bandwidth_model: BandwidthModel = dataclasses.field(
        default_factory=lambda: DEFAULT_BANDWIDTH_MODEL
    )
    copies: Counter = dataclasses.field(default_factory=Counter)
    bytes_moved: Counter = dataclasses.field(default_factory=Counter)
    # per-(src,dst) modeled seconds — with a topology model the keys are
    # the individual *links* each routed transfer traversed
    modeled_by_pair: Counter = dataclasses.field(default_factory=Counter)
    modeled_seconds: float = 0.0
    flag_checks: int = 0  # last-resource-flag checks (§5.2.2 microbench)
    # -- capacity-pressure counters --
    evictions: Counter = dataclasses.field(default_factory=Counter)  # per loc
    evicted_bytes: int = 0
    writeback_bytes: int = 0  # dirty bytes written back on eviction
    spill_stall_s: float = 0.0  # modeled seconds staging spent on write-backs
    n_spill_stalls: int = 0  # alloc attempts that had to evict first
    prefetch_deferrals: int = 0  # prefetches skipped to protect queued readers
    # -- spill-to-peer counters --
    spills_to_peer: int = 0  # evictions whose write-back went to a peer arena
    peer_writeback_bytes: int = 0  # dirty bytes spilled device→device
    # -- per-client (multi-tenant) counters --
    client_tasks: Counter = dataclasses.field(default_factory=Counter)
    client_bytes: Counter = dataclasses.field(default_factory=Counter)
    client_service_s: Counter = dataclasses.field(default_factory=Counter)
    client_stall_s: Counter = dataclasses.field(default_factory=Counter)
    client_evictions: Counter = dataclasses.field(default_factory=Counter)
    client_writeback_bytes: Counter = dataclasses.field(default_factory=Counter)
    client_failures: Counter = dataclasses.field(default_factory=Counter)
    # -- tracing hook: when a TraceCollector is attached, every
    # record() emits a matching trace event *under the ledger lock*, so
    # trace_lint's conservation check (trace events == ledger counters)
    # holds by construction rather than by sampling.
    tracer: object = dataclasses.field(default=None, repr=False, compare=False)
    trace_label: str = dataclasses.field(default="", repr=False, compare=False)
    _lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False
    )

    def record(self, src: Location, dst: Location, nbytes: int,
               seconds: Optional[float] = None) -> None:
        """Record one copy (or one hop of a routed copy).  ``seconds``
        overrides the bandwidth model's estimate — routed staging passes
        the per-link service time so multi-hop accounting stays exact."""
        key = (str(src), str(dst))
        if seconds is None:
            seconds = self.bandwidth_model.seconds(src, dst, nbytes)
        with self._lock:
            self.copies[key] += 1
            self.bytes_moved[key] += nbytes
            self.modeled_by_pair[key] += seconds
            self.modeled_seconds += seconds
            if self.tracer is not None:
                self.tracer.transfer(self.trace_label, key[0], key[1],
                                     nbytes, seconds)

    def attach_tracer(self, tracer, label: str) -> dict:
        """Attach a TraceCollector atomically w.r.t. in-flight records.

        Returns the per-link counters already accumulated at attach time
        — the conservation baseline ``trace_lint`` nets out, since those
        copies predate the trace."""
        with self._lock:
            baseline = self.per_link_summary()
            self.tracer = tracer
            self.trace_label = label
        return baseline

    def record_eviction(self, loc: Location, nbytes: int,
                        writeback_bytes: int, stall_s: float,
                        target: Optional[Location] = None,
                        owner: Optional[str] = None) -> None:
        with self._lock:
            self.evictions[str(loc)] += 1
            self.evicted_bytes += nbytes
            self.writeback_bytes += writeback_bytes
            self.spill_stall_s += stall_s
            if owner is not None:
                self.client_evictions[owner] += 1
                self.client_writeback_bytes[owner] += writeback_bytes
            if (target is not None and target.kind != "host"
                    and writeback_bytes > 0):
                self.spills_to_peer += 1
                self.peer_writeback_bytes += writeback_bytes

    def record_spill_stall(self, n: int = 1) -> None:
        with self._lock:
            self.n_spill_stalls += n

    def record_prefetch_deferral(self, n: int = 1) -> None:
        with self._lock:
            self.prefetch_deferrals += n

    # -- per-client (multi-tenant) accounting ---------------------
    def record_client_task(self, client: Optional[str], nbytes: int,
                           service_s: float) -> None:
        """One completed task attributed to ``client``: its input bytes
        and the modeled service it consumed (staging + spill stall +
        compute estimate + output transfer) — the quantity
        :meth:`fairness_report` computes Jain's index over."""
        if client is None:
            return
        with self._lock:
            self.client_tasks[client] += 1
            self.client_bytes[client] += nbytes
            self.client_service_s[client] += service_s

    def record_client_stall(self, client: Optional[str],
                            seconds: float) -> None:
        """Seconds a client's submitter spent blocked in QoS admission
        (backpressure window or DRR queue)."""
        if client is None:
            return
        with self._lock:
            self.client_stall_s[client] += seconds

    def record_client_failure(self, client: Optional[str]) -> None:
        if client is None:
            return
        with self._lock:
            self.client_failures[client] += 1

    def client_names(self) -> list:
        with self._lock:
            names = (set(self.client_tasks) | set(self.client_bytes)
                     | set(self.client_service_s) | set(self.client_stall_s)
                     | set(self.client_evictions) | set(self.client_failures))
        return sorted(names)

    def fairness_report(self, weights: Optional[dict] = None,
                        clients: Optional[list] = None) -> dict:
        """Per-client QoS evidence + Jain's fairness index.

        The index is computed over each selected client's
        *weight-normalized modeled service* (``service_model_s /
        weight``): with equal weights it measures how equally the runtime
        served the clients; with configured weights, 1.0 means service
        landed exactly in the weight ratios.  ``clients`` restricts the
        index to a subset (e.g. the equal-demand light tenants in
        ``bench_multitenant`` — comparing tenants with deliberately
        unequal demands would conflate demand with unfairness);
        ``weights`` default to 1.0 per client.
        """
        names = sorted(clients) if clients is not None else self.client_names()
        w = {n: float((weights or {}).get(n, 1.0)) for n in names}
        with self._lock:
            per = {
                n: {
                    "tasks": self.client_tasks.get(n, 0),
                    "bytes": self.client_bytes.get(n, 0),
                    "service_model_s": self.client_service_s.get(n, 0.0),
                    "stall_s": self.client_stall_s.get(n, 0.0),
                    "evictions": self.client_evictions.get(n, 0),
                    "failures": self.client_failures.get(n, 0),
                    "weight": w[n],
                }
                for n in names
            }
        shares = [per[n]["service_model_s"] / w[n] for n in names]
        return {
            "clients": per,
            "n_clients": len(names),
            "jain_index": jain_index(shares),
        }

    def record_flag_check(self, n: int = 1) -> None:
        # Deliberately lock-free: this sits on the §5.2.2 flag-check hot
        # path, and flag_checks is a diagnostic counter where a rare lost
        # update under contention is acceptable.
        self.flag_checks += n

    # -- aggregates -------------------------------------------------------
    @property
    def total_copies(self) -> int:
        return sum(self.copies.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_moved.values())

    @property
    def total_evictions(self) -> int:
        return sum(self.evictions.values())

    def per_link_summary(self) -> dict:
        """The per-(src,dst) traffic matrix: one row per directed pair
        (with a topology model, per *link* — multi-hop transfers appear
        once per hop they traversed)."""
        with self._lock:
            return {
                f"{s}->{d}": {
                    "copies": c,
                    "bytes": self.bytes_moved[(s, d)],
                    "modeled_s": self.modeled_by_pair[(s, d)],
                }
                for (s, d), c in sorted(self.copies.items())
            }

    def reset(self) -> None:
        with self._lock:
            self.copies.clear()
            self.bytes_moved.clear()
            self.modeled_by_pair.clear()
            self.modeled_seconds = 0.0
            self.flag_checks = 0
            self.evictions.clear()
            self.evicted_bytes = 0
            self.writeback_bytes = 0
            self.spill_stall_s = 0.0
            self.n_spill_stalls = 0
            self.prefetch_deferrals = 0
            self.spills_to_peer = 0
            self.peer_writeback_bytes = 0
            self.client_tasks.clear()
            self.client_bytes.clear()
            self.client_service_s.clear()
            self.client_stall_s.clear()
            self.client_evictions.clear()
            self.client_writeback_bytes.clear()
            self.client_failures.clear()
            if self.tracer is not None:
                # Open a fresh conservation epoch: trace events recorded
                # before this point no longer correspond to any counter.
                self.tracer.ledger_reset(self.trace_label)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "total_copies": self.total_copies,
                "total_bytes": self.total_bytes,
                "modeled_seconds": self.modeled_seconds,
                "flag_checks": self.flag_checks,
                "by_pair": {
                    f"{s}->{d}": c for (s, d), c in sorted(self.copies.items())
                },
                "per_link": self.per_link_summary(),
                "evictions": dict(sorted(self.evictions.items())),
                "total_evictions": self.total_evictions,
                "evicted_bytes": self.evicted_bytes,
                "writeback_bytes": self.writeback_bytes,
                "spill_stall_s": self.spill_stall_s,
                "n_spill_stalls": self.n_spill_stalls,
                "prefetch_deferrals": self.prefetch_deferrals,
                "spills_to_peer": self.spills_to_peer,
                "peer_writeback_bytes": self.peer_writeback_bytes,
                "client_tasks": dict(sorted(self.client_tasks.items())),
                "client_service_s": dict(
                    sorted(self.client_service_s.items())
                ),
                "client_writeback_bytes": dict(
                    sorted(self.client_writeback_bytes.items())
                ),
            }


#: process-global ledger; runtimes may use their own instance instead.
ledger = TransferLedger()


@contextlib.contextmanager
def fresh_ledger(
    led: Optional[TransferLedger] = None,
) -> Iterator[TransferLedger]:
    """Context manager: reset (or swap in) a ledger for one experiment.

    Semantics (deliberate, tested in ``tests/test_instrument.py``): the
    target ledger is reset on entry and the counts accumulated inside
    the block are **kept** on exit — they are the experiment's evidence.
    Nothing is restored; a caller that needs the pre-experiment counts
    takes its own :meth:`TransferLedger.snapshot` first.
    """
    target = led if led is not None else ledger
    target.reset()
    yield target


class Timer:
    """Monotonic wall-clock timer for benchmark harnesses."""

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self.start


# ---------------------------------------------------------------------------
# Per-task timeline — Gantt-style evidence for transfer/compute overlap
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TimelineEvent:
    """One executed task: wall-clock and modeled intervals on one PE.

    ``model_start``/``model_end`` come from the executor's schedule
    simulation (modeled transfer seconds + measured compute seconds), so
    a Gantt over them shows where overlap saved modeled makespan even on
    a box where all PEs share one physical CPU.
    """

    task: str
    pe: str
    wall_start: float
    wall_end: float
    model_start: float
    model_end: float
    transfer_s: float  # modeled input-staging seconds (0 on flag hits)
    compute_s: float  # measured kernel seconds
    out_transfer_s: float = 0.0  # modeled output writeback (reference policy)
    spill_s: float = 0.0  # modeled eviction write-back stall during staging
    # modeled instant the kernel itself starts (staging + spill done);
    # -1.0 on legacy events — consumers fall back to model_start+transfer_s
    compute_start_m: float = -1.0
    node: int = -1  # graph node index (-1 when not graph-scheduled)


@dataclasses.dataclass(frozen=True)
class TransferEvent:
    """One hop of a routed transfer occupying one interconnect link in
    modeled time — the Gantt's transfer lanes."""

    link: str  # link label, e.g. "host:cpu->device:gpu0"
    task: str  # consumer task the bytes were staged for
    nbytes: int
    model_start: float
    model_end: float
    node: int = -1  # consumer's graph node index (-1 when unknown)


class Timeline:
    """Thread-safe ordered record of :class:`TimelineEvent` (per-PE
    compute lanes) and :class:`TransferEvent` (per-link transfer
    lanes)."""

    def __init__(self) -> None:
        self._events: List[TimelineEvent] = []
        self._transfers: List[TransferEvent] = []
        self._lock = threading.Lock()

    def add(self, ev: TimelineEvent) -> None:
        with self._lock:
            self._events.append(ev)

    def add_transfer(self, ev: TransferEvent) -> None:
        with self._lock:
            self._transfers.append(ev)

    def events(self) -> List[TimelineEvent]:
        with self._lock:
            return sorted(self._events, key=lambda e: (e.model_start, e.pe))

    def transfers(self) -> List[TransferEvent]:
        with self._lock:
            return sorted(
                self._transfers, key=lambda e: (e.model_start, e.link)
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def makespan_model(self) -> float:
        with self._lock:
            return max((e.model_end for e in self._events), default=0.0)

    @property
    def total_spill_s(self) -> float:
        """Modeled seconds tasks stalled on eviction write-backs."""
        with self._lock:
            return sum(e.spill_s for e in self._events)

    def gantt(self, width: int = 72) -> str:
        """Render a text Gantt chart over modeled time: one row per PE
        (``#`` compute) and, when routed transfers were recorded, one
        lane per interconnect link (``=`` link busy)."""
        width = max(width, 12)  # room for the axis label row
        evs = self.events()
        xfers = self.transfers()
        if not evs and not xfers:
            return "(empty timeline)"
        span = (
            max(
                [e.model_end for e in evs]
                + [x.model_end for x in xfers]
            )
            or 1.0
        )
        labels = sorted({e.pe for e in evs}) + sorted({x.link for x in xfers})
        lw = max([10] + [len(label) for label in labels])

        def paint(line, start, end, mark):
            a = int(start / span * (width - 1))
            b = max(a + 1, int(end / span * (width - 1)))
            for i in range(a, min(b, width)):
                line[i] = mark if line[i] == " " else "+"

        rows = []
        for pe in sorted({e.pe for e in evs}):
            line = [" "] * width
            for e in evs:
                if e.pe == pe:
                    paint(line, e.model_start, e.model_end, "#")
            rows.append(f"{pe:>{lw}s} |{''.join(line)}|")
        for link in sorted({x.link for x in xfers}):
            line = [" "] * width
            for x in xfers:
                if x.link == link:
                    paint(line, x.model_start, x.model_end, "=")
            rows.append(f"{link:>{lw}s} |{''.join(line)}|")
        rows.append(
            f"{'':>{lw}s}  0{'':{width - 10}s}{span * 1e3:.2f} ms (modeled)"
        )
        return "\n".join(rows)
