"""Multi-tenant QoS for session streams.

The session API made one :class:`~repro_torch.core.api.Session` the front door for N
concurrent client threads — but admission was first-come-first-served
and unbounded, so one greedy client could flood the stream, starve the
others' placement, and pin a whole device arena.  This module is the
arbitration layer between submitters and the
:class:`~repro_torch.core.executor.StreamExecutor`:

* **per-client backpressure** — every client (explicit
  :meth:`~repro_torch.core.api.Session.client` handle or the implicit
  per-thread client) has a bounded *in-flight window*: ``submit`` blocks
  while the client already has ``window`` admitted-but-incomplete tasks
  (or raises :class:`BackpressureFull` under ``nowait=True``), keeping
  the admitted frontier small enough for windowed HEFT to stay
  effective;
* **weighted fair admission** — when submissions wait (their own window
  or the stream's optional global window is full), freed slots are
  granted by a **deficit round-robin** over the waiting clients: each
  round credits every backlogged client ``quantum × weight`` bytes of
  deficit, and a client is granted its head-of-line submission only
  when its deficit covers the task's byte cost — so admitted service
  converges to the configured weight ratios, independent of how
  aggressively each client submits;
* **per-tenant arena quotas** — :class:`QuotaExceeded` (an
  :class:`~repro_torch.core.allocator.AllocError`) is the *per-tenant*
  exhaustion signal: a tenant exceeding its reservation budget in a
  device arena fails alone (see :meth:`~repro_torch.core.hete.HeteContext.set_quota`),
  instead of exhausting the arena for everyone;
* **deterministic QoS replay** — :func:`fair_replay` extends the
  executor's deterministic schedule replay with a virtual re-enactment
  of admission itself: each client's recorded task sequence is released
  through its window and the DRR queue in *modeled* time, so per-client
  latency and fairness metrics depend only on every client's own
  submission order (deterministic) — never on wall-clock thread
  interleaving — and can be gated in CI byte-exactly
  (``benchmarks/bench_multitenant.py``).

Per-client observability (task/byte/stall/eviction counters and the
Jain's-index ``fairness_report``) lives on the
:class:`~repro_torch.core.instrument.TransferLedger`.
"""

from __future__ import annotations

import heapq
import itertools
import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .allocator import AllocError
from .instrument import Timeline, TimelineEvent, TransferEvent

__all__ = [
    "BackpressureFull",
    "QuotaExceeded",
    "ClientState",
    "DrrWheel",
    "QoSManager",
    "admission_cost",
    "fair_replay",
    "DEFAULT_CLIENT",
]

#: client name tasks fall under when no client was named (fair_replay
#: groups them into one unbounded tenant, preserving pre-QoS behaviour).
DEFAULT_CLIENT = "_default"


class BackpressureFull(RuntimeError):
    """``submit(nowait=True)`` found the client's in-flight window (or
    the stream's global admission window) full — resubmit after a
    completion, or use the blocking default."""


class QuotaExceeded(AllocError):
    """A tenant's arena reservation budget is exhausted.  Unlike a plain
    capacity :class:`~repro_torch.core.allocator.AllocError`, this failure is
    *per-tenant*: the arena may still have room for other tenants, and
    only the offending tenant's task subtree fails."""

    def __init__(self, msg: str, *, tenant: Optional[str] = None,
                 location: Any = None) -> None:
        super().__init__(msg)
        self.tenant = tenant
        self.location = location


def admission_cost(task: Any) -> int:
    """DRR byte cost of admitting one task: its input + output bytes
    (floored at 1 so zero-byte tasks still consume deficit).  Shared by
    live admission (:meth:`QoSManager.admit` callers) and the virtual
    admission in :func:`fair_replay`, so both charge identically."""
    return max(1, int(task.in_bytes) + int(task.out_bytes))


class ClientState:
    """One tenant's QoS state: configuration (weight, in-flight window,
    optional arena quota) plus the manager-owned live counters.  Mutable
    fields are guarded by the owning :class:`QoSManager`'s lock."""

    __slots__ = ("name", "weight", "window", "quota_bytes", "think_s",
                 "slo_latency_s", "slo_target",
                 "inflight", "deficit", "admitted", "waiting")

    def __init__(self, name: str, *, weight: float = 1.0, window: int = 64,
                 quota_bytes: Optional[int] = None,
                 think_s: float = 0.0,
                 slo_latency_s: Optional[float] = None,
                 slo_target: float = 0.99) -> None:
        if weight <= 0:
            raise ValueError(f"client weight must be > 0, got {weight}")
        if window <= 0:
            raise ValueError(f"client window must be > 0, got {window}")
        if think_s < 0:
            raise ValueError(f"client think_s must be >= 0, got {think_s}")
        if slo_latency_s is not None and slo_latency_s <= 0:
            raise ValueError(
                f"client slo_latency_s must be > 0, got {slo_latency_s}")
        if not 0.0 < slo_target < 1.0:
            raise ValueError(
                f"client slo_target must be in (0, 1), got {slo_target}")
        self.name = name
        self.weight = float(weight)
        self.window = int(window)
        self.quota_bytes = quota_bytes
        # Closed-loop think time:
        # the modeled pause between one of this client's tasks finishing
        # and its next submission becoming admissible.  0 = open-loop
        # (submissions are available as fast as windows allow).  Only the
        # deterministic replay (fair_replay) consumes it — live
        # admission sees real submission timing.
        self.think_s = float(think_s)
        # Per-tenant latency SLO: a modeled-latency objective
        # this tenant declared.  None = no objective; qos_report() grows
        # an ``slo`` section (burn rate, breached flag) and the trace
        # gains alert instants for tenants that set one.
        self.slo_latency_s = (None if slo_latency_s is None
                              else float(slo_latency_s))
        self.slo_target = float(slo_target)
        self.inflight = 0  # admitted-but-incomplete tasks
        self.deficit = 0.0  # DRR byte credit (only while backlogged)
        self.admitted = 0  # total grants (diagnostics)
        self.waiting: deque = deque()  # (ticket, byte cost) FIFO

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ClientState({self.name!r}, weight={self.weight}, "
                f"window={self.window}, inflight={self.inflight}, "
                f"waiting={len(self.waiting)})")


class DrrWheel:
    """Token-passing deficit round robin — the grant-order core shared
    by the live :class:`QoSManager` and the virtual admission in
    :func:`fair_replay` (so both produce the same weighted order).

    The *token* stays with one client while its deficit covers its
    head-of-line cost; each fresh visit credits ``quantum × weight``.
    A client whose deficit runs dry (or who becomes ineligible) passes
    the token on; a full ineligible-or-unaffordable cycle fast-forwards
    every eligible client's deficit by whole rounds, so a grant costs
    O(clients), never O(cost/quantum).  Deficits die with the backlog
    (:meth:`drained`), as in classic DRR.
    """

    def __init__(self, quantum: int) -> None:
        self.quantum = int(quantum)
        self.order: List[str] = []
        self.deficit: Dict[str, float] = {}
        self.weight: Dict[str, float] = {}
        self.pos = 0
        self.fresh = True

    def add(self, name: str, weight: float) -> None:
        if name not in self.deficit:
            self.order.append(name)
            self.deficit[name] = 0.0
        self.weight[name] = float(weight)

    def drained(self, name: str) -> None:
        """The client's backlog emptied: its unused credit expires."""
        self.deficit[name] = 0.0

    def _advance(self) -> None:
        self.pos = (self.pos + 1) % max(1, len(self.order))
        self.fresh = True

    def next_grant(self, eligible, head_cost) -> Optional[str]:
        """The next client to grant, by token order (its head cost is
        deducted from its deficit).  ``eligible(name)`` says whether the
        client has a waiting submission AND window room; ``head_cost``
        returns its head-of-line byte cost.  Returns None when no client
        is eligible."""
        n = len(self.order)
        if n == 0 or not any(eligible(x) for x in self.order):
            return None
        passes = 0
        while True:
            name = self.order[self.pos % len(self.order)]
            if not eligible(name):
                self._advance()
                passes += 1
            else:
                if self.fresh:
                    self.deficit[name] += self.quantum * self.weight[name]
                    self.fresh = False
                cost = head_cost(name)
                if self.deficit[name] >= cost:
                    self.deficit[name] -= cost
                    return name
                self._advance()
                passes += 1
            if passes > len(self.order):
                # Full cycle, no grant: bulk-replenish whole DRR rounds
                # until the neediest eligible client can afford.
                elig = [x for x in self.order if eligible(x)]
                rounds = max(1, math.ceil(min(
                    (head_cost(x) - self.deficit[x])
                    / (self.quantum * self.weight[x])
                    for x in elig
                )))
                for x in elig:
                    self.deficit[x] += rounds * self.quantum * self.weight[x]
                passes = 0


class QoSManager:
    """Admission arbiter for one session stream: per-client windows, an
    optional global window, and deficit-round-robin grant order among
    waiting clients.

    The *per-client* window is pure backpressure (a client blocks only
    on its own completions); the optional *global* window is the shared
    resource the DRR weights arbitrate — when the admitted frontier is
    capped, freed slots are granted across waiting clients in
    weight-proportional bursts.

    Thread-safe; lock order is strictly *after* the stream lock (the
    session calls :meth:`admit` with no locks held and :meth:`release`
    from the stream's completion callback), so the manager never takes
    another lock while holding its own.
    """

    def __init__(self, *, default_window: int = 64,
                 global_window: Optional[int] = None,
                 quantum_bytes: int = 64 << 10) -> None:
        if quantum_bytes <= 0:
            raise ValueError("quantum_bytes must be > 0")
        self.default_window = int(default_window)
        self.global_window = global_window
        self.quantum_bytes = int(quantum_bytes)
        self._cv = threading.Condition()
        self._clients: Dict[str, ClientState] = {}
        self._wheel = DrrWheel(self.quantum_bytes)
        self._granted: set = set()
        self._n_waiting = 0
        self._total_inflight = 0
        self._seq = itertools.count()

    # -- registration --------------------------------------------------------
    def client(self, name: str, *, weight: Optional[float] = None,
               window: Optional[int] = None,
               quota_bytes: Optional[int] = None,
               think_s: Optional[float] = None,
               slo_latency_s: Optional[float] = None,
               slo_target: Optional[float] = None) -> ClientState:
        """Get-or-create the named client; passed keywords update the
        existing configuration (omitted ones are preserved)."""
        with self._cv:
            st = self._clients.get(name)
            if st is None:
                st = ClientState(
                    name,
                    weight=weight if weight is not None else 1.0,
                    window=window if window is not None else self.default_window,
                    quota_bytes=quota_bytes,
                    think_s=think_s if think_s is not None else 0.0,
                    slo_latency_s=slo_latency_s,
                    slo_target=slo_target if slo_target is not None else 0.99,
                )
                self._clients[name] = st
                self._wheel.add(name, st.weight)
            else:
                if weight is not None:
                    if weight <= 0:
                        raise ValueError("client weight must be > 0")
                    st.weight = float(weight)
                    self._wheel.add(name, st.weight)
                if window is not None:
                    if window <= 0:
                        raise ValueError("client window must be > 0")
                    st.window = int(window)
                if quota_bytes is not None:
                    st.quota_bytes = quota_bytes
                if think_s is not None:
                    if think_s < 0:
                        raise ValueError("client think_s must be >= 0")
                    st.think_s = float(think_s)
                if slo_latency_s is not None:
                    if slo_latency_s <= 0:
                        raise ValueError("client slo_latency_s must be > 0")
                    st.slo_latency_s = float(slo_latency_s)
                if slo_target is not None:
                    if not 0.0 < slo_target < 1.0:
                        raise ValueError(
                            "client slo_target must be in (0, 1)")
                    st.slo_target = float(slo_target)
            return st

    def weights(self) -> Dict[str, float]:
        with self._cv:
            return {n: c.weight for n, c in self._clients.items()}

    def params(self) -> Dict[str, Any]:
        """Deterministic snapshot of the admission configuration — the
        input :func:`fair_replay` re-enacts."""
        with self._cv:
            return {
                "clients": {
                    n: {"weight": c.weight, "window": c.window,
                        "quota_bytes": c.quota_bytes,
                        "think_s": c.think_s,
                        "slo_latency_s": c.slo_latency_s,
                        "slo_target": c.slo_target}
                    for n, c in self._clients.items()
                },
                "default_window": self.default_window,
                "global_window": self.global_window,
                "quantum_bytes": self.quantum_bytes,
            }

    # -- admission -----------------------------------------------------------
    def _has_room(self, st: ClientState) -> bool:
        if st.inflight >= st.window:
            return False
        if (self.global_window is not None
                and self._total_inflight >= self.global_window):
            return False
        return True

    def _grant(self, st: ClientState) -> None:
        st.inflight += 1
        st.admitted += 1
        self._total_inflight += 1

    def admit(self, st: ClientState, cost: int, *, nowait: bool = False,
              timeout: Optional[float] = None) -> float:
        """Admit one submission of byte ``cost`` for client ``st``.
        Fast-paths when nothing is waiting and the windows have room;
        otherwise blocks in the DRR queue (or raises
        :class:`BackpressureFull` under ``nowait=True``).  Returns the
        seconds spent blocked (0.0 on the fast path) — the session
        records it as the client's admission stall."""
        cost = max(1, int(cost))
        with self._cv:
            if self._n_waiting == 0 and self._has_room(st):
                self._grant(st)
                return 0.0
            ticket = next(self._seq)
            st.waiting.append((ticket, cost))
            self._n_waiting += 1
            if nowait:
                # One real DRR pass: the slot may be grantable right now
                # (e.g. other clients' waiters are blocked on their own
                # windows); only an actually-ungrantable submission
                # raises.
                self._pump()
                if ticket in self._granted:
                    self._granted.discard(ticket)
                    return 0.0
                st.waiting = deque(x for x in st.waiting if x[0] != ticket)
                self._n_waiting -= 1
                raise BackpressureFull(
                    f"client {st.name!r} backpressured: {st.inflight}/"
                    f"{st.window} in flight"
                    + ("" if self.global_window is None else
                       f", {self._total_inflight}/{self.global_window} global")
                )
            t0 = time.perf_counter()
            self._pump()
            ok = self._cv.wait_for(lambda: ticket in self._granted, timeout)
            if not ok:
                st.waiting = deque(x for x in st.waiting if x[0] != ticket)
                self._n_waiting -= 1
                raise TimeoutError(
                    f"client {st.name!r} admission timed out after {timeout}s"
                )
            self._granted.discard(ticket)
            return time.perf_counter() - t0

    def release(self, st: ClientState) -> None:
        """One of the client's admitted tasks completed (or failed, or
        was cancelled before reaching the stream): free its slot and
        grant waiting submissions."""
        with self._cv:
            if st.inflight <= 0:
                raise ValueError(f"release without admit for {st.name!r}")
            st.inflight -= 1
            self._total_inflight -= 1
            self._pump()
            self._cv.notify_all()

    def _pump(self) -> None:
        """Grant as many waiting submissions as the windows allow, in
        token-order deficit round robin (called under the lock)."""

        def eligible(name: str) -> bool:
            c = self._clients[name]
            return bool(c.waiting) and c.inflight < c.window

        def head_cost(name: str) -> int:
            return self._clients[name].waiting[0][1]

        while True:
            if (self.global_window is not None
                    and self._total_inflight >= self.global_window):
                return
            name = self._wheel.next_grant(eligible, head_cost)
            if name is None:
                return
            c = self._clients[name]
            ticket, cost = c.waiting.popleft()
            self._n_waiting -= 1
            c.deficit = self._wheel.deficit[name]  # diagnostics mirror
            if not c.waiting:
                self._wheel.drained(name)
                c.deficit = 0.0
            self._grant(c)
            self._granted.add(ticket)
            self._cv.notify_all()

    # -- evidence ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "total_inflight": self._total_inflight,
                "waiting": self._n_waiting,
                "clients": {
                    n: {"inflight": c.inflight, "admitted": c.admitted,
                        "waiting": len(c.waiting), "weight": c.weight,
                        "window": c.window,
                        "deficit": self._wheel.deficit.get(n, 0.0)}
                    for n, c in self._clients.items()
                },
            }


# ---------------------------------------------------------------------------
# Deterministic QoS-aware schedule replay
# ---------------------------------------------------------------------------


def fair_replay(
    rt: Any,
    nodes: List[Any],
    records: Dict[int, tuple],
    topo: Any = None,
    qos: Any = None,
) -> Tuple[Timeline, float, Dict[int, float], Dict[int, float]]:
    """Re-simulate an executed stream *including admission* in virtual
    time.

    :func:`~repro_torch.core.executor.replay_schedule` treats every recorded
    task as available at its dependency readiness — correct for one
    batch, but blind to multi-tenant pacing: a backlogged client's 96
    roots would all contend at t=0 even though backpressure admitted
    them a window at a time.  This replay re-enacts the QoS policy
    deterministically:

    * each client's recorded tasks form a queue in that client's own
      submission order (deterministic run to run — unlike the global
      interleaving, which is thread-timing);
    * a task is **released** when the virtual DRR admission (weights,
      per-client windows, optional global window — from
      ``qos.params()``) grants it a slot; window slots free at task
      completion in virtual time;
    * execution then follows the recorded placements exactly like
      ``replay_schedule`` — per-PE busy-until, routed per-link
      contention under a topology — but a task can never start before
      ``max(release, dependency finishes)``;
    * a client configured with ``think_s > 0`` is replayed closed-loop:
      after each of its completions the client
      "thinks" for ``think_s`` virtual seconds before its next queued
      submission becomes admissible, so replayed latencies match
      closed-loop submission semantics instead of treating every
      backlog as an open-loop burst.

    Every ordering key is ``(time, client name, within-client seq)``, so
    the result is byte-identical across runs and machines.  Clients are
    rotated in sorted-name order (the live manager rotates in
    registration order, which is thread-raced — the replay substitutes
    its own deterministic rotation).

    Returns ``(timeline, modeled makespan, finish, release)`` with
    ``finish``/``release`` keyed by node index — the per-chain latency
    evidence ``bench_multitenant`` gates on.
    """
    params = qos.params() if isinstance(qos, QoSManager) else dict(qos or {})
    cfg = params.get("clients", {})
    default_window = int(params.get("default_window", 64))
    global_window = params.get("global_window")
    quantum = int(params.get("quantum_bytes", 64 << 10))

    if topo is not None:
        topo.reset_contention()

    by_client: Dict[str, List[int]] = {}
    for i in sorted(records):
        name = nodes[i].task.client or DEFAULT_CLIENT
        by_client.setdefault(name, []).append(i)
    names = sorted(by_client)
    weight = {n: float(cfg.get(n, {}).get("weight", 1.0)) for n in names}
    window = {
        n: (len(by_client[n]) if n == DEFAULT_CLIENT and n not in cfg
            else int(cfg.get(n, {}).get("window", default_window)))
        for n in names
    }
    seq_of: Dict[int, Tuple[str, int]] = {}
    for n, idxs in by_client.items():
        for k, i in enumerate(idxs):
            seq_of[i] = (n, k)

    pending = {n: deque(idxs) for n, idxs in by_client.items()}
    inflight = {n: 0 for n in names}
    # Closed-loop think time: a client with
    # ``think_s > 0`` models a submitter who waits for a completion,
    # "thinks", then submits again — its next pending task becomes
    # admissible no earlier than (previous completion + think_s).  Open
    # loop (think_s = 0, the default) keeps the original semantics:
    # everything a window allows is admissible immediately.
    think = {n: float(cfg.get(n, {}).get("think_s", 0.0)) for n in names}
    next_ok = {n: 0.0 for n in names}
    wakeups: List[Tuple[float, str]] = []  # think-time admission retries
    wheel = DrrWheel(quantum)
    for n in names:  # sorted: the replay's deterministic rotation order
        wheel.add(n, weight[n])
    state = {"total": 0}

    release: Dict[int, float] = {}
    finish: Dict[int, float] = {}
    remaining = {
        i: sum(1 for d in nodes[i].deps if d in records) for i in records
    }
    ready: List[Tuple[float, str, int, int]] = []  # (t, client, seq, idx)
    completions: List[Tuple[float, str, int, int]] = []

    def push_ready(i: int, t: float) -> None:
        c, k = seq_of[i]
        heapq.heappush(ready, (t, c, k, i))

    def admit_at(t: float) -> None:
        def eligible(n: str) -> bool:
            return (bool(pending[n]) and inflight[n] < window[n]
                    and next_ok[n] <= t)

        def head_cost(n: str) -> int:
            return admission_cost(nodes[pending[n][0]].task)

        while True:
            if (global_window is not None
                    and state["total"] >= global_window):
                return
            n = wheel.next_grant(eligible, head_cost)
            if n is None:
                return
            i = pending[n].popleft()
            if not pending[n]:
                wheel.drained(n)
            inflight[n] += 1
            state["total"] += 1
            release[i] = t
            if remaining[i] == 0:
                dep_t = max(
                    (finish[d] for d in nodes[i].deps if d in records),
                    default=0.0,
                )
                push_ready(i, max(t, dep_t))

    timeline = Timeline()
    pe_free: Dict[str, float] = {pe.name: 0.0 for pe in rt.pes}
    admit_at(0.0)
    while ready or completions or wakeups:
        t_r = ready[0][0] if ready else math.inf
        t_c = completions[0][0] if completions else math.inf
        t_w = wakeups[0][0] if wakeups else math.inf
        if t_c <= t_r and t_c <= t_w:
            end, c, _, _ = heapq.heappop(completions)
            inflight[c] -= 1
            state["total"] -= 1
            if think[c] > 0.0:
                # the client observes this completion, thinks, then its
                # next submission becomes admissible
                next_ok[c] = max(next_ok[c], end + think[c])
                if pending[c]:
                    heapq.heappush(wakeups, (next_ok[c], c))
            admit_at(end)
            continue
        if t_w <= t_r:
            t, _ = heapq.heappop(wakeups)
            admit_at(t)
            continue
        ready_m, c, k, i = heapq.heappop(ready)
        node = nodes[i]
        (pe_name, moves, comp_m, spill_s, out_s, tr_s, comp_s,
         w0, w1) = records[i]
        if topo is not None:
            stage_end = ready_m
            for src, dst, nbytes in moves:
                _, end, hops = topo.transfer(src, dst, nbytes, at=ready_m,
                                             commit=True)
                for link, hs, he in hops:
                    timeline.add_transfer(TransferEvent(
                        link=link.label, task=node.name, nbytes=nbytes,
                        model_start=hs, model_end=he, node=i,
                    ))
                stage_end = max(stage_end, end)
        else:
            stage_end = ready_m + tr_s
        start = max(pe_free[pe_name], stage_end + spill_s)
        end = start + comp_m + out_s
        pe_free[pe_name] = end
        finish[i] = end
        stage_s = (stage_end - ready_m) + spill_s
        timeline.add(TimelineEvent(
            task=node.name, pe=pe_name, wall_start=w0, wall_end=w1,
            model_start=max(ready_m, start - stage_s), model_end=end,
            transfer_s=tr_s, compute_s=comp_s, out_transfer_s=out_s,
            spill_s=spill_s, compute_start_m=start, node=i,
        ))
        heapq.heappush(completions, (end, c, k, i))
        for s in sorted(node.dependents):
            if s in remaining and s in records:
                remaining[s] -= 1
                if remaining[s] == 0 and s in release:
                    dep_t = max(
                        (finish[d] for d in nodes[s].deps if d in records),
                        default=0.0,
                    )
                    push_ready(s, max(release[s], dep_t))
    return timeline, max(finish.values(), default=0.0), finish, release
