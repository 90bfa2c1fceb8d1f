"""Task-graph construction + cost modeling for the async executor.

RIMMS's premise (§3.2.2) is that the runtime knows where valid bytes
live; this module gives the runtime the *other* half of what it needs to
exploit that: which API calls are actually ordered.  From each
:class:`~repro_torch.core.runtime.Task`'s ``HeteData`` read/write sets we build
a dependency DAG automatically:

* **RAW** — a task reading a buffer depends on the buffer's live writers;
* **WAW** — a task writing a buffer depends on its earlier writers;
* **WAR** — a task writing a buffer depends on earlier readers (their
  input staging must not observe the new bytes).

Aliasing: a fragment (§3.2.3) aliases its parent allocation over its
byte interval; sibling fragments are disjoint and stay independent, so a
fragmented Pulse-Doppler phase parallelizes across ways while a task
touching the whole parent still orders against every fragment.

:class:`CostModel` provides per-(op, pe_kind) compute estimates — a
throughput prior refined online by an EMA of measured kernel seconds —
and, together with a :class:`~repro_torch.core.locations.BandwidthModel`, the
upward-rank computation used by the HEFT-lite scheduler in
:mod:`repro_torch.core.executor`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["TaskNode", "TaskGraph", "GraphBuilder", "build_graph", "CostModel"]


@dataclasses.dataclass
class TaskNode:
    """One task in the DAG, with its dependency edges (by node index)."""

    index: int
    task: "Task"  # repro_torch.core.runtime.Task (duck-typed; no import cycle)
    deps: Set[int] = dataclasses.field(default_factory=set)
    dependents: Set[int] = dataclasses.field(default_factory=set)
    rank: float = 0.0  # HEFT upward rank (filled by compute_ranks)

    @property
    def name(self) -> str:
        return self.task.name or self.task.op


class TaskGraph:
    """An immutable DAG over a submitted task list."""

    def __init__(self, nodes: List[TaskNode]) -> None:
        self.nodes = nodes

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def n_edges(self) -> int:
        return sum(len(n.deps) for n in self.nodes)

    def roots(self) -> List[TaskNode]:
        return [n for n in self.nodes if not n.deps]

    def edges(self) -> List[Tuple[int, int]]:
        return sorted(
            (d, n.index) for n in self.nodes for d in n.deps
        )

    @property
    def critical_path_len(self) -> int:
        """Length (in tasks) of the longest dependency chain."""
        depth = [0] * len(self.nodes)
        for n in self.nodes:  # nodes are in submission order; deps point back
            depth[n.index] = 1 + max((depth[d] for d in n.deps), default=0)
        return max(depth, default=0)

    def compute_ranks(
        self,
        compute_cost: Callable[["Task"], float],
        comm_cost: Callable[["Task"], float],
    ) -> None:
        """Fill each node's HEFT *upward rank*: its mean compute cost plus
        the most expensive (communication + rank) path to an exit node."""
        for n in reversed(self.nodes):
            succ = max(
                (comm_cost(self.nodes[s].task) + self.nodes[s].rank
                 for s in n.dependents),
                default=0.0,
            )
            n.rank = compute_cost(n.task) + succ


def _overlaps(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


def _covers(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    return a[0] <= b[0] and b[1] <= a[1]


class GraphBuilder:
    """Incremental RAW/WAR/WAW dependency tracking.

    The streaming session front-end (:mod:`repro_torch.core.api`) submits tasks
    one at a time against *live* buffers; this builder extends the DAG
    per submission — :meth:`add` resolves the new task's dependencies
    from the live access state and updates it, in O(live accesses on the
    touched buffers), never re-scanning earlier tasks.  Batch
    :func:`build_graph` is a loop over :meth:`add`, so both entry points
    produce identical DAGs by construction.

    Dependency state is keyed on **HeteData versions**: every write
    submission bumps the target root's version counter, and the builder
    remembers which node produced each buffer's current version (the
    live-writer set per byte interval).  A
    :class:`~repro_torch.core.api.BufferFuture` binds to the (buffer, version)
    pair its producing task will publish.

    Not thread-safe by itself — the session serializes :meth:`add` under
    its submission lock (admission order must equal node order).
    """

    def __init__(self) -> None:
        self.nodes: List[TaskNode] = []
        # per root allocation: live accesses as (interval, node_index)
        self._writes: Dict[int, List[Tuple[Tuple[int, int], int]]] = {}
        self._reads: Dict[int, List[Tuple[Tuple[int, int], int]]] = {}
        # id(root) -> write version (0 = the initial host bytes); bumped
        # once per writing task at *submission* time
        self._versions: Dict[int, int] = {}
        # id(root) -> index of the node that wrote it last (any interval)
        self._last_writer: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self.nodes)

    def version_of(self, hd: "HeteData") -> int:
        """Current submitted write version of ``hd``'s root (0 before any
        writer was submitted)."""
        return self._versions.get(id(hd.root), 0)

    def last_writer(self, hd: "HeteData") -> Optional[int]:
        """Index of the last submitted node writing ``hd``'s root, or
        None if the buffer was never a task output."""
        return self._last_writer.get(id(hd.root))

    def add(self, task: "Task") -> TaskNode:
        """Append ``task``, resolving its deps against the live access
        state.  Deps always point to earlier submissions, so the graph
        stays a DAG by construction."""
        i = len(self.nodes)
        node = TaskNode(i, task)
        writes, reads = self._writes, self._reads
        for hd in task.inputs:
            key, iv = id(hd.root), hd.byte_interval()
            # RAW: order after every live writer touching this interval
            for w_iv, w_idx in writes.get(key, ()):
                if _overlaps(iv, w_iv):
                    node.deps.add(w_idx)
            reads.setdefault(key, []).append((iv, i))
        for hd in task.outputs:
            key, iv = id(hd.root), hd.byte_interval()
            for w_iv, w_idx in writes.get(key, ()):  # WAW
                if w_idx != i and _overlaps(iv, w_iv):
                    node.deps.add(w_idx)
            for r_iv, r_idx in reads.get(key, ()):  # WAR
                if r_idx != i and _overlaps(iv, r_iv):
                    node.deps.add(r_idx)
            # This write shadows fully-covered earlier accesses: future
            # tasks order against us, and transitively against them.
            writes[key] = [
                (w_iv, w_idx) for w_iv, w_idx in writes.get(key, ())
                if not _covers(iv, w_iv)
            ] + [(iv, i)]
            reads[key] = [
                (r_iv, r_idx) for r_iv, r_idx in reads.get(key, ())
                if r_idx == i or not _covers(iv, r_iv)
            ]
            self._versions[key] = self._versions.get(key, 0) + 1
            self._last_writer[key] = i
        self.nodes.append(node)
        for d in node.deps:
            self.nodes[d].dependents.add(i)
        return node

    def graph(self) -> TaskGraph:
        """The DAG over everything added so far (shares the node list —
        later :meth:`add` calls keep extending it)."""
        return TaskGraph(self.nodes)


def build_graph(tasks: Sequence["Task"]) -> TaskGraph:
    """Build the RAW/WAR/WAW dependency DAG from ``tasks``' read/write
    sets (batch intake: one :class:`GraphBuilder` pass in submission
    order)."""
    builder = GraphBuilder()
    for t in tasks:
        builder.add(t)
    return builder.graph()


# ---------------------------------------------------------------------------
# Cost model — per-(op, pe_kind) compute estimates for HEFT-lite
# ---------------------------------------------------------------------------


class CostModel:
    """Per-(op, pe_kind) compute-seconds estimates.

    Prior: bytes / throughput, with a per-kind base throughput and a
    per-op weight (FFTs cost ~5× an elementwise zip per byte).  Every
    measured kernel execution refines the estimate via an EMA of observed
    seconds-per-byte, so schedules improve as the run progresses.

    Measured calibration: when a
    :class:`~repro_torch.core.calibrate.CalibrationTable` is attached
    (:meth:`set_calibration` — e.g. via ``Session(calibration=...)``),
    :meth:`prior_estimate` consults the table's measured cell for the
    exact ``(op, pe_kind, shape bucket)`` *before* falling back to the
    ``BASE_THROUGHPUT`` prior, so placement and the modeled replays
    price work from measured hardware.  No table attached (the default)
    keeps the historical deterministic priors — committed bench
    baselines depend on that.
    """

    BASE_THROUGHPUT = {  # bytes/second prior per PE kind
        "cpu": 1.0e9,
        "acc": 8.0e9,
        "gpu": 1.6e10,
    }
    OP_WEIGHT = {"fft": 5.0, "ifft": 5.0, "zip": 1.0}
    LAUNCH_LATENCY_S = 20e-6  # per-dispatch overhead floor
    EMA = 0.3

    def __init__(self, calibration=None) -> None:
        self._observed: Dict[Tuple[str, str], float] = {}  # s per byte
        self._lock = threading.Lock()
        self._calibration = calibration

    def set_calibration(self, table) -> None:
        """Attach (or detach with None) a calibration table; measured
        cells then take precedence over the throughput priors."""
        self._calibration = table

    @property
    def calibration(self):
        return self._calibration

    def prior_estimate(self, op: str, pe_kind: str, nbytes: int) -> float:
        """Static estimate — deterministic, used for the schedule
        *simulation* so serial and graph modeled makespans are directly
        comparable (measured kernel times are inflated by cross-PE
        contention for shared cores and devices in graph mode).  A measured calibration
        cell for this exact (op, kind, bucket) wins; missing cells fall
        back to the throughput prior."""
        if self._calibration is not None:
            measured = self._calibration.estimate_s(
                op, pe_kind, nbytes, launch_s=self.LAUNCH_LATENCY_S)
            if measured is not None:
                return measured
        bw = self.BASE_THROUGHPUT.get(pe_kind, 1.0e9)
        per_byte = self.OP_WEIGHT.get(op, 2.0) / bw
        return self.LAUNCH_LATENCY_S + nbytes * per_byte

    def estimate(self, op: str, pe_kind: str, nbytes: int) -> float:
        """Best current estimate (observed EMA when available, else the
        prior) — used for HEFT placement decisions."""
        with self._lock:
            per_byte = self._observed.get((op, pe_kind))
        if per_byte is None:
            return self.prior_estimate(op, pe_kind, nbytes)
        return self.LAUNCH_LATENCY_S + nbytes * per_byte

    def observe(self, op: str, pe_kind: str, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        per_byte = max(seconds - self.LAUNCH_LATENCY_S, 0.0) / nbytes
        with self._lock:
            prev = self._observed.get((op, pe_kind))
            self._observed[(op, pe_kind)] = (
                per_byte if prev is None
                else (1 - self.EMA) * prev + self.EMA * per_byte
            )

    def mean_estimate(self, op: str, pe_kinds: Sequence[str], nbytes: int) -> float:
        kinds = list(pe_kinds) or ["cpu"]
        return sum(self.estimate(op, k, nbytes) for k in kinds) / len(kinds)
