"""Async task executors: persistent per-PE workers, prefetch, HEFT-lite.

Two engines share one persistent :class:`WorkerPool` (one worker thread
per PE plus a transfer pool, owned by the
:class:`~repro_torch.core.runtime.Runtime`, reused across runs):

* :class:`StreamExecutor` — **streaming admission**: the
  engine behind the primary :class:`repro_torch.core.api.Session` API.  Tasks
  are admitted one at a time as the application submits them and the
  pool consumes the stream continuously — a task dispatches the moment
  its dependencies complete, placement is a **windowed HEFT** over the
  ready frontier (upward ranks recomputed over the admitted, incomplete
  window), there is no global barrier, and a failing task fails only its
  dependent subtree (futures carry the cause) while independent chains
  keep flowing.
* :class:`GraphExecutor` — batch intake for the
  :meth:`~repro_torch.core.runtime.Runtime.run_graph` compat wrapper: takes a
  whole task list, runs it to completion, and tears the run down on the
  first failure (nothing commits after an error).

Shared mechanics (both engines):

* **input prefetch**: the moment a task's dependencies complete, its
  input staging (``hete_Data`` flag checks + src→PE copies) is submitted
  to the transfer pool, so the copy overlaps whatever the target PE is
  still computing — the paper's §3.2.2 premise (the runtime knows where
  valid bytes live) finally buys wall-clock, not just copy counts;
* **topology-aware prefetch ordering**: when a
  batch of tasks becomes ready together under an interconnect topology,
  their prefetch stagings are issued least-contended-route-first —
  transfers whose routes are free start warming immediately instead of
  queueing behind a busy shared link;
* **capacity-aware prefetch**: inputs of every scheduled-but-
  incomplete task are *protected* in the :class:`HeteContext`; prefetch
  staging runs under the context's prefetch guard, so it never evicts
  bytes a queued task still reads — if a reservation would require that,
  the prefetch defers (:class:`~repro_torch.core.hete.PrefetchDeferred`).
  Prefetch is pin-free *speculative warming*: the PE worker re-stages
  authoritatively (with hard pins) before executing — a free flag hit
  when the warmed bytes survived, a demand fetch otherwise — so
  concurrent prefetches can never pin an arena full and starve a
  worker's reservation;
* scheduling: ``round_robin`` (static, bit-identical to serial dispatch),
  ``data_affinity`` (dynamic, flag-aware), or ``heft`` — a HEFT
  list scheduler that ranks ready tasks by upward rank and places each
  with an **insertion-based slot search**: a task may slide
  into an idle gap on a PE's modeled timeline left by earlier
  placements, not just append after the last one.  Costs come from the
  bandwidth model — routed and **contention-aware** when the context
  uses a :class:`~repro_torch.core.topology.TopologyBandwidthModel` — and the
  online :class:`~repro_torch.core.graph.CostModel`;
* **deterministic replay** (:func:`replay_schedule`): modeled makespans
  and Gantt lanes are produced by re-simulating the executed schedule in
  (ready-time, submission-index) order — per-link busy-until contention
  applied when a topology is active — so gated metrics stay exact across
  runs even though worker wall-clock interleaving varies.

Because several PEs may share one physical device (every accelerator
space maps onto one card, and CPU PEs share the host's cores), the
*measured* wall clock understates the win; the executors therefore also simulate
the schedule they actually executed (modeled transfer + spill-stall
seconds + static compute estimates) and report a modeled makespan,
directly comparable to the serial :meth:`Runtime.run` modeled makespan.
"""

from __future__ import annotations

import bisect
import heapq
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple, TYPE_CHECKING)

from .graph import TaskGraph, TaskNode, build_graph
from .hete import PrefetchDeferred
from .instrument import Timeline, TimelineEvent, TransferEvent

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids import cycle
    from .runtime import PE, Runtime, Task

__all__ = ["GraphExecutor", "StreamExecutor", "WorkerPool", "insert_slot",
           "replay_schedule"]

_SHUTDOWN = None


def insert_slot(busy: List[Tuple[float, float]], earliest: float,
                duration: float) -> float:
    """HEFT insertion-based slot search: the earliest start ≥ ``earliest``
    at which ``duration`` fits into the sorted busy-interval list — an
    idle gap between existing placements, or after the last one.
    ``busy`` intervals may abut but never overlap (they are produced by
    :func:`commit_slot`)."""
    t = earliest
    for s, e in busy:
        if t + duration <= s:
            break  # fits entirely in the gap before this interval
        t = max(t, e)
    return t


def commit_slot(busy: List[Tuple[float, float]], start: float,
                duration: float) -> None:
    """Reserve ``[start, start+duration)`` in the sorted interval list."""
    bisect.insort(busy, (start, start + duration))


class WorkerPool:
    """Persistent per-PE worker threads + transfer pool.

    Lives on the :class:`Runtime` and is reused by every run —
    batch ``run_graph`` calls and streaming sessions alike; each queue
    item is ``(executor_run, payload)`` so the same threads serve
    successive runs.  ``shutdown`` is only needed for explicit teardown —
    threads are daemons.
    """

    def __init__(self, pes: Sequence["PE"]) -> None:
        self.pe_names = tuple(pe.name for pe in pes)
        self.closed = False
        self.queues: Dict[str, "queue.Queue"] = {
            pe.name: queue.Queue() for pe in pes
        }
        # Per-PE busy flags: set by the worker loop around each
        # payload so the telemetry sampler can read occupancy without
        # touching the queues.  Plain dict writes — sampling tolerates a
        # stale read; the hot path takes no lock.
        self.active: Dict[str, bool] = {pe.name: False for pe in pes}
        self.transfer = ThreadPoolExecutor(
            max_workers=max(2, len(pes)), thread_name_prefix="rimms-xfer",
        )
        self.runs_served = 0
        self._threads = [
            threading.Thread(
                target=self._loop, args=(pe,), name=f"rimms-{pe.name}",
                daemon=True,
            )
            for pe in pes
        ]
        for t in self._threads:
            t.start()

    def submit(self, run, pe_name: str, payload) -> None:
        self.queues[pe_name].put((run, payload))

    def _loop(self, pe: "PE") -> None:
        q = self.queues[pe.name]
        while True:
            item = q.get()
            if item is _SHUTDOWN:
                return
            run, payload = item
            self.active[pe.name] = True
            try:
                run._process(pe, payload)
            finally:
                self.active[pe.name] = False

    def drain(self, run) -> list:
        """Pop every queued payload belonging to ``run`` (run teardown;
        no other run is active on this pool by construction)."""
        out = []
        for q in self.queues.values():
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is _SHUTDOWN:
                    q.put(item)  # preserve shutdown signal
                    break
                if item[0] is run:
                    out.append(item[1])
                else:  # pragma: no cover - defensive; runs never overlap
                    q.put(item)
                    break
        return out

    def shutdown(self) -> None:
        self.closed = True
        for q in self.queues.values():
            q.put(_SHUTDOWN)
        # Join so no daemon thread is left inside a kernel call at
        # interpreter teardown (std::terminate on some builds).
        for t in self._threads:
            t.join(timeout=5.0)
        self.transfer.shutdown(wait=True)


def _reap_future(fut: Optional[Future]) -> None:
    """Cancel an abandoned prefetch future, or — if it already started —
    wait and swallow its outcome so staging errors are never left
    unretrieved.  Prefetch staging is pin-free speculative warming, so
    there is nothing else to release."""
    if fut is not None and not fut.cancel():
        try:
            fut.exception()
        except BaseException:
            pass


def _execute_task(rt: "Runtime", task: "Task", pe: "PE",
                  fut: Optional[Future]) -> tuple:
    """Authoritative execution of one task on its PE worker thread:
    validate/reuse the speculative prefetch staging (pin first, then
    check eviction epochs), fall back to pinned demand staging, run the
    kernel, commit outputs, release pins.  Returns
    ``(w0, w1, tr_s, spill_s, comp_s, out_s, moves)`` — wall bounds plus
    the modeled accounting both executors feed their schedule
    simulations."""
    tracer = rt.context.tracer
    w0 = time.perf_counter()
    pre = fut.result() if fut is not None else None
    loc = pe.location
    staged = None
    if pre is not None:
        # Pin first, then validate: once pinned the inputs cannot be
        # evicted, so unchanged eviction epochs prove the prefetched
        # staging is still current.
        pre_staged, epochs = pre
        rt._pin_inputs(task, loc)
        if all(hd.root.eviction_epoch == ep
               for hd, ep in zip(task.inputs, epochs)):
            staged = pre_staged
        else:  # pressure evicted warmed bytes: stage on demand
            rt._unpin_inputs(task, loc)
    if staged is None:
        # no prefetch, prefetch deferred, or warmed bytes evicted —
        # authoritative pinned staging
        staged = rt._stage_inputs(task, pe)
        if pre is not None:  # account the wasted warm-up too
            staged = (staged[0], staged[1] + pre[0][1],
                      staged[2] + pre[0][2], pre[0][3] + staged[3])
    ins, tr_s, sp_s, moves = staged
    w_staged = time.perf_counter()
    try:
        outs, comp_s = rt._run_kernel(task, pe, ins)
        w_comp = time.perf_counter()
        out_s, sp2_s = rt._commit_outputs(task, pe, outs)
    finally:
        rt._unpin_inputs(task, pe.location)
    w1 = time.perf_counter()
    rt.divergence.observe("stage", task.op, pe.kind, task.in_bytes,
                          w_staged - w0, tr_s + sp_s)
    if tracer is not None:
        tname = task.name or task.op
        targs = {"task": tname, "op": task.op, "client": task.client}
        tracer.span(tname, "stage", f"pe:{pe.name}:stage", w0, w_staged, targs)
        tracer.span(tname, "compute", f"pe:{pe.name}", w_staged, w_comp, targs)
        tracer.span(tname, "writeback", f"pe:{pe.name}", w_comp, w1, targs)
    return w0, w1, tr_s, sp_s + sp2_s, comp_s, out_s, moves


def replay_schedule(rt: "Runtime", nodes: Sequence[TaskNode],
                    records: Dict[int, tuple],
                    topo=None) -> Tuple[Timeline, float]:
    """Deterministically re-simulate an executed schedule.

    The executors' online accounting runs in worker completion order,
    which varies run to run — fine for scalar sums but not for gated
    metrics.  This replay processes the recorded placements, transfers
    and compute estimates in (ready-time, submission-index) order: a
    task's input copies are issued the moment its dependencies finish,
    its compute starts when both the staged bytes and the PE are free.
    With a :class:`~repro_torch.core.topology.Topology` the copies walk their
    routes through per-link busy-until contention (a shared bridge
    serializes them) and per-link Gantt transfer lanes are emitted;
    without one, staging is the recorded store-and-forward seconds.

    ``records`` may cover a *subset* of ``nodes`` (a stream replays only
    completed tasks); a recorded task's dependencies are always recorded
    too, because it could not have run before them.  Returns
    ``(timeline, modeled makespan)``."""
    if topo is not None:
        topo.reset_contention()
    timeline = Timeline()
    pe_free: Dict[str, float] = {pe.name: 0.0 for pe in rt.pes}
    finish: Dict[int, float] = {}
    remaining = {i: len(nodes[i].deps) for i in records}
    heap: List[Tuple[float, int]] = [
        (0.0, i) for i, r in remaining.items() if r == 0
    ]
    heapq.heapify(heap)
    while heap:
        ready_m, i = heapq.heappop(heap)
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
        for s in list(node.dependents):
            if s in remaining:
                remaining[s] -= 1
                if remaining[s] == 0:
                    heapq.heappush(heap, (
                        max(finish[d] for d in nodes[s].deps), s
                    ))
    return timeline, max(finish.values(), default=0.0)


class _ExecutorBase:
    """Scheduling + prefetch machinery shared by the batch and streaming
    engines.  Subclasses own run lifecycle and completion bookkeeping;
    they must provide ``_nodes`` (admitted :class:`TaskNode` list),
    ``_model_finish``, ``_pe_slots`` and ``_pool``."""

    def __init__(self, rt: "Runtime", *, scheduler: Optional[str] = None,
                 prefetch: bool = True) -> None:
        from .runtime import SCHEDULERS  # local: no cycle at module load

        self.rt = rt
        self.scheduler = scheduler or rt.scheduler
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        self.prefetch = prefetch
        # interconnect topology, when the context routes transfers
        self._topo = getattr(
            rt.context.ledger.bandwidth_model, "topology", None
        )
        # cross-client interference: ready-but-unplaced tasks of
        # the current dispatch batch, index -> (client, eligible PE names).
        # The streaming engine fills it so heft placement can charge a
        # candidate the delay it imposes on *other* clients' ready tasks.
        self._copending: Dict[int, Tuple[Optional[str], frozenset]] = {}

    # -- placement ----------------------------------------------------------
    def _staging_delay(self, task: "Task", pe: "PE", at: float) -> float:
        """Extra modeled wait the task's input transfers would queue on
        busy interconnect links if issued at ``at`` (0 without a
        topology) — the contention term of HEFT placement."""
        if self._topo is None:
            return 0.0
        delay = 0.0
        for hd in task.inputs:
            src = hd.last_location
            if src != pe.location:
                delay = max(delay, self._topo.queue_delay(
                    src, pe.location, hd.nbytes, at=at))
        return delay

    def _ready_m(self, node: TaskNode) -> float:
        return max(
            (self._model_finish.get(d, 0.0) for d in node.deps), default=0.0
        )

    def _interference(self, task: "Task", pe: "PE", est: float) -> float:
        """Modeled delay placing ``task`` on ``pe`` imposes on *other
        clients'* ready-but-unplaced tasks: occupying ``pe``
        for ``est`` seconds delays each co-pending task that could use
        this PE, prorated by 1/|its eligible PEs| (the chance it needs
        exactly this one).  Zero without client attribution — the batch
        engine and single-tenant streams place exactly as before."""
        if not self._copending or task.client is None:
            return 0.0
        pen = 0.0
        for client, names in self._copending.values():
            if client is not None and client != task.client and pe.name in names:
                pen += est / len(names)
        return pen

    def _eligible_names(self, task: "Task") -> frozenset:
        if task.pin is not None:
            return frozenset((task.pin,))
        try:
            return frozenset(pe.name for pe in self.rt._eligible(task))
        except LookupError:
            return frozenset()

    def _pick_pe(self, node: TaskNode) -> "PE":
        """Dynamic placement for a ready node (deps complete ⇒ input flags
        are final). Called under the run's state lock."""
        rt, task = self.rt, node.task
        if task.pin is not None:
            return rt.by_name[task.pin]
        pes = rt._eligible(task)
        if self.scheduler == "data_affinity":
            return rt._affinity_pick(task, pes)
        # heft: earliest-estimated-finish-time placement, on the same
        # cost basis as serial heft dispatch (Runtime._heft_costs) plus
        # input-readiness, link-contention, an insertion-based slot
        # search over each PE's modeled busy intervals, and a
        # cross-client interference charge — the comparison key
        # adds the delay this placement imposes on other clients' ready
        # tasks, while the committed slot stays the physical [start, est).
        ready_m = self._ready_m(node)

        def placement(pe: "PE") -> Tuple[float, float, float]:
            tr, est = rt._heft_costs(task, pe)
            earliest = ready_m + tr + self._staging_delay(task, pe, ready_m)
            start = insert_slot(self._pe_slots[pe.name], earliest, est)
            return start + est + self._interference(task, pe, est), start, est

        efts = {pe.name: placement(pe) for pe in pes}
        best = min(pes, key=lambda pe: (efts[pe.name][0], pe.name))
        _, start, est = efts[best.name]
        commit_slot(self._pe_slots[best.name], start, est)
        if self._topo is not None:
            # Commit this task's expected link traffic so later
            # placements see the shared links as busy.
            for hd in task.inputs:
                src = hd.last_location
                if src != best.location:
                    self._topo.transfer(src, best.location, hd.nbytes,
                                        at=ready_m, commit=True)
        return best

    # -- prefetch -----------------------------------------------------------
    def _prefetch_order(
        self, assigned: List[Tuple[int, "PE"]]
    ) -> List[Tuple[int, "PE"]]:
        """Topology-aware prefetch issue order: when
        several tasks become ready together, warm the ones whose input
        routes are currently *least contended* first — a transfer with a
        free route starts moving bytes immediately, while one that would
        queue on a busy shared link yields its transfer-pool slot.
        Order is (modeled queue delay, submission index); without a
        topology the submission order is kept unchanged."""
        if self._topo is None or len(assigned) < 2:
            return assigned

        def delay(item: Tuple[int, "PE"]) -> float:
            i, pe = item
            node = self._nodes[i]
            at = self._ready_m(node)
            return max(
                (self._topo.queue_delay(hd.last_location, pe.location,
                                        hd.nbytes, at=at)
                 for hd in node.task.inputs
                 if hd.last_location != pe.location),
                default=0.0,
            )

        return sorted(assigned, key=lambda item: (delay(item), item[0]))

    def _prefetch_stage(self, task: "Task", pe: "PE"):
        """Speculative pin-free staging on the transfer pool.  Returns
        ``(staged, eviction_epochs)`` — the worker reuses ``staged`` only
        if every input root's eviction epoch is unchanged once pinned —
        or None when capacity pressure defers to demand staging (never
        evicting bytes another queued task still reads)."""
        tracer = self.rt.context.tracer
        t0 = time.perf_counter() if tracer is not None else 0.0
        try:
            staged = self.rt._stage_inputs(task, pe, prefetch=True)
        except PrefetchDeferred:
            return None
        if tracer is not None:
            tname = task.name or task.op
            tracer.span(tname, "stage", f"pe:{pe.name}:stage",
                        t0, time.perf_counter(),
                        {"task": tname, "prefetch": True})
        return staged, tuple(hd.root.eviction_epoch for hd in task.inputs)

    # -- claims -------------------------------------------------------------
    def _unprotect(self, node: TaskNode, pe: "PE") -> None:
        for hd in node.task.inputs:
            self.rt.context.unprotect(hd, pe.location)

    def _abandon(self, payload: tuple) -> None:
        """Release claims of a payload that will never execute: reap its
        prefetch future and drop the queued-reader protection."""
        i, pe, fut = payload
        _reap_future(fut)
        self._unprotect(self._nodes[i], pe)


class GraphExecutor(_ExecutorBase):
    """Executes one task list as a DAG on a :class:`Runtime`'s PEs
    (batch intake — the engine behind the ``run_graph`` compat wrapper;
    the streaming :class:`StreamExecutor` is the primary entry point)."""

    # -- public entry -------------------------------------------------------
    def run(self, tasks: Sequence["Task"]) -> Dict[str, Any]:
        rt = self.rt
        rt.timeline = Timeline()
        graph = build_graph(tasks)
        if not len(graph):
            rt.last_makespan_model = 0.0
            return self._report(graph, 0.0)

        self._graph = graph
        self._nodes = graph.nodes
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._remaining = [len(n.deps) for n in graph.nodes]
        self._completed = 0
        self._model_finish: Dict[int, float] = {}
        self._pe_model: Dict[str, float] = {pe.name: 0.0 for pe in rt.pes}
        # HEFT insertion-based slot search: per-PE sorted busy
        # intervals on the scheduler's modeled timeline.
        self._pe_slots: Dict[str, List[Tuple[float, float]]] = {
            pe.name: [] for pe in rt.pes
        }
        if self._topo is not None:
            self._topo.reset_contention()
        # per-task execution records feeding the deterministic replay:
        # (pe name, moves, comp_m, spill_s, out_s, tr_s, comp_s, w0, w1)
        self._records: Dict[int, tuple] = {}
        # run lifecycle: late items (after teardown) are abandoned, and
        # teardown waits until in-flight items leave the workers
        self._finished = False
        self._inflight = 0
        self._quiet = threading.Condition()

        if self.scheduler == "heft":
            self._rank(graph)
        # Static policies assign in submission order so placement (and
        # therefore rimms copy counts) is bit-identical to serial run().
        self._static: Optional[List["PE"]] = None
        if self.scheduler == "round_robin":
            self._static = [rt._schedule(n.task) for n in graph.nodes]

        pool = rt._get_worker_pool()
        pool.runs_served += 1
        self._pool = pool

        self._t0 = time.perf_counter()
        try:
            with self._lock:
                ready = [n.index for n in graph.nodes if not n.deps]
                self._schedule_ready(ready)
            self._done.wait()
        finally:
            with self._quiet:
                self._finished = True
                # Wait out in-flight workers FIRST: a completing peer can
                # still enqueue dependents and prefetch futures (failure
                # teardown); only after quiescence is the queue content
                # final.
                while self._inflight:
                    self._quiet.wait()
            # Reap items abandoned on any queue: cancel their prefetch
            # futures — or wait out started ones — and release their pins
            # and protection, so no staging outlives the run unaccounted.
            # (Workers popping later see _finished and abandon likewise.)
            for payload in pool.drain(self):
                self._abandon(payload)
        wall = time.perf_counter() - self._t0
        if self._error is not None:
            raise self._error
        if self._topo is not None:
            rt.timeline, rt.last_makespan_model = replay_schedule(
                rt, graph.nodes, self._records, self._topo
            )
        else:
            rt.last_makespan_model = max(
                self._model_finish.values(), default=0.0
            )
        tracer = rt.context.tracer
        if tracer is not None:
            run_label = tracer.add_timeline(rt.timeline, label="graph")
            tracer.add_edges(graph.edges(), run_label)
        return self._report(graph, wall)

    # -- scheduling ---------------------------------------------------------
    def _rank(self, graph: TaskGraph) -> None:
        rt, cm = self.rt, self.rt.cost_model
        bw = rt.context.ledger.bandwidth_model

        def compute_cost(task: "Task") -> float:
            kinds = sorted({pe.kind for pe in rt._eligible(task)})
            return cm.mean_estimate(task.op, kinds, task.in_bytes)

        def comm_cost(task: "Task") -> float:
            return bw.typical(task.in_bytes)

        graph.compute_ranks(compute_cost, comm_cost)

    def _schedule_ready(self, indices: List[int]) -> None:
        """Assign + enqueue newly-ready nodes (under the state lock).
        HEFT processes the batch highest-upward-rank first.  Each node's
        inputs are protected at its PE until completion — the contract
        behind capacity-aware prefetch.  Prefetch stagings are issued
        least-contended-route-first; PE queue order
        keeps the assignment order."""
        nodes = self._graph.nodes
        ctx = self.rt.context
        if self.scheduler == "heft":
            indices = sorted(indices, key=lambda i: -nodes[i].rank)
        assigned: List[Tuple[int, "PE"]] = []
        for i in indices:
            node = nodes[i]
            pe = self._static[i] if self._static is not None else self._pick_pe(node)
            for hd in node.task.inputs:
                ctx.protect(hd, pe.location)
            assigned.append((i, pe))
        futs: Dict[int, Future] = {}
        if self.prefetch:
            # Prefetch: stage inputs now, possibly while the PE is still
            # busy with an earlier task — transfer/compute overlap.
            for i, pe in self._prefetch_order(assigned):
                futs[i] = self._pool.transfer.submit(
                    self._prefetch_stage, nodes[i].task, pe
                )
        for i, pe in assigned:
            self._pool.submit(self, pe.name, (i, pe, futs.get(i)))

    # -- workers ------------------------------------------------------------
    def _process(self, pe: "PE", payload: tuple) -> None:
        """Execute one queued payload on its PE worker thread.  Called by
        the persistent pool; must never kill the worker thread."""
        with self._quiet:
            if self._finished:
                live = False
            else:
                live = True
                self._inflight += 1
        if not live:
            self._abandon(payload)
            return
        try:
            if self._error is not None:
                # A peer already failed: drain without executing.
                self._abandon(payload)
                return
            i, pe_assigned, fut = payload
            node = self._graph.nodes[i]
            unprotected = False
            try:
                (w0, w1, tr_s, spill_s, comp_s, out_s, moves) = _execute_task(
                    self.rt, node.task, pe_assigned, fut
                )
                # This task no longer reads its inputs: release the
                # queued-reader claim exactly once, before dependents are
                # scheduled (inside _complete).
                self._unprotect(node, pe_assigned)
                unprotected = True
                # _complete can itself raise while scheduling newly-ready
                # dependents (unknown pin, op with no eligible PE) — it
                # must stay inside the except so the run never hangs.
                self._complete(node, pe_assigned, w0, w1, tr_s,
                               spill_s, comp_s, out_s, moves)
            except BaseException as e:  # surface to the caller, stop the run
                with self._lock:
                    if self._error is None:
                        self._error = e
                if not unprotected:
                    self._unprotect(node, pe_assigned)
                self._done.set()
        finally:
            with self._quiet:
                self._inflight -= 1
                self._quiet.notify_all()

    def _complete(
        self,
        node: TaskNode,
        pe: "PE",
        w0: float,
        w1: float,
        tr_s: float,
        spill_s: float,
        comp_s: float,
        out_s: float,
        moves: Sequence[tuple] = (),
    ) -> None:
        rt = self.rt
        with self._lock:
            # Schedule simulation: this task's transfers could start once
            # its inputs existed (ready_m), overlapping the PE's previous
            # compute; its compute starts when both the PE and the staged
            # inputs are available.  Spill stalls extend staging.
            ready_m = self._ready_m(node)
            # Static compute estimate, not contended measured seconds —
            # keeps the simulation comparable to serial run() (see
            # CostModel.prior_estimate).
            comp_m = rt.cost_model.prior_estimate(
                node.task.op, pe.kind, node.task.in_bytes
            )
            stage_s = tr_s + spill_s
            compute_start_m = max(self._pe_model[pe.name], ready_m + stage_s)
            finish_m = compute_start_m + comp_m + out_s
            self._pe_model[pe.name] = finish_m
            self._model_finish[node.index] = finish_m
            rt.timeline.add(TimelineEvent(
                task=node.name, pe=pe.name,
                wall_start=w0 - self._t0, wall_end=w1 - self._t0,
                model_start=max(ready_m, compute_start_m - stage_s),
                model_end=finish_m,
                transfer_s=tr_s, compute_s=comp_s, out_transfer_s=out_s,
                spill_s=spill_s, compute_start_m=compute_start_m,
                node=node.index,
            ))
            rt.task_log.append((node.name, pe.name))
            self._records[node.index] = (
                pe.name, tuple(moves), comp_m, spill_s, out_s, tr_s,
                comp_s, w0 - self._t0, w1 - self._t0,
            )
            self._completed += 1
            newly_ready: List[int] = []
            for s in node.dependents:
                self._remaining[s] -= 1
                if self._remaining[s] == 0:
                    newly_ready.append(s)
            # A peer failed: the run is tearing down — don't feed new
            # work (or prefetch staging) into a dying run.
            if newly_ready and self._error is None:
                self._schedule_ready(newly_ready)
            if self._completed == len(self._graph):
                self._done.set()

    # -- reporting ----------------------------------------------------------
    def _report(self, graph: TaskGraph, wall: float) -> Dict[str, Any]:
        rt = self.rt
        per_pe: Dict[str, float] = {}
        for ev in rt.timeline.events():
            per_pe[ev.pe] = per_pe.get(ev.pe, 0.0) + (ev.model_end - ev.model_start)
        ledger = rt.context.ledger
        return {
            "wall_s": wall,
            "makespan_model": rt.last_makespan_model,
            "n_tasks": len(graph),
            "n_edges": graph.n_edges,
            "critical_path": graph.critical_path_len,
            "scheduler": self.scheduler,
            "policy": rt.policy,
            "prefetch": self.prefetch,
            "topology": self._topo.name if self._topo is not None else None,
            "per_pe_busy_model_s": per_pe,
            "timeline": rt.timeline,
            "spill_stall_model_s": rt.timeline.total_spill_s,
            "evictions": ledger.total_evictions,
            "prefetch_deferrals": ledger.prefetch_deferrals,
        }


class StreamExecutor(_ExecutorBase):
    """Continuous task-stream engine — the execution half of
    the primary :class:`repro_torch.core.api.Session` API.

    Where :class:`GraphExecutor` takes a whole task list and runs it to
    completion, this engine **admits** tasks one at a time as the
    session submits them, and the persistent :class:`WorkerPool`
    consumes the stream continuously:

    * :meth:`admit` wires a freshly built
      :class:`~repro_torch.core.graph.TaskNode` into the live run — it
      dispatches immediately when its dependencies are already complete,
      otherwise the completion of its last dependency dispatches it.
      There is **no global barrier**: the ready frontier flows straight
      onto the PE queues;
    * **windowed HEFT**: ``heft`` placement ranks only the admitted,
      incomplete window of the DAG (upward ranks recomputed over what is
      known *now*, bounded by ``window`` admissions), then places each
      ready task with the shared contention-aware insertion-based slot
      search;
    * **per-subtree failure**: a failing task fails its dependent
      subtree — every transitively dependent node is marked failed with
      the same root cause, surfaced through
      :class:`~repro_torch.core.api.BufferFuture` results — while independent
      chains keep flowing.  :meth:`barrier` re-raises the first
      *unobserved* root failure;
    * an ``on_done`` callback (index, exception-or-None), invoked under
      the stream lock at every completion or failure, lets the session
      resolve futures and release buffer lifecycles out of order, as
      tasks actually finish.

    Modeled evidence: online accounting mirrors the batch engine
    (per-PE model clocks, task log, timeline events); :meth:`report`
    re-simulates everything completed so far with the deterministic
    :func:`replay_schedule` — call it at a sync point for exact,
    machine-independent makespans (the bench_stream CI gate does).
    """

    def __init__(
        self,
        rt: "Runtime",
        *,
        scheduler: Optional[str] = None,
        prefetch: bool = True,
        on_done: Optional[Callable[[int, Optional[BaseException]], None]] = None,
        window: int = 64,
    ) -> None:
        super().__init__(rt, scheduler=scheduler, prefetch=prefetch)
        self.window = window
        self._on_done = on_done
        # Reentrant: the session serializes GraphBuilder mutations under
        # this same lock (see state_lock) and admit() re-enters it.
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._nodes: List[TaskNode] = []
        self._admitted = 0
        self._completed: Set[int] = set()
        self._failed: Dict[int, BaseException] = {}
        # root failures no barrier/result() raised yet (dependents
        # cascade-fail with the same exception but count as observed —
        # the root cause is what the caller must see exactly once)
        self._unobserved: List[int] = []
        self._remaining: Dict[int, int] = {}
        self._static_pe: Dict[int, "PE"] = {}
        self._model_finish: Dict[int, float] = {}
        self._pe_model: Dict[str, float] = {pe.name: 0.0 for pe in rt.pes}
        self._pe_slots: Dict[str, List[Tuple[float, float]]] = {
            pe.name: [] for pe in rt.pes
        }
        self._records: Dict[int, tuple] = {}
        self.timeline = Timeline()
        self._closed = False
        if self._topo is not None:
            self._topo.reset_contention()
        self._pool = rt._get_worker_pool()
        self._pool.runs_served += 1
        self._t0 = time.perf_counter()

    # -- admission ----------------------------------------------------------
    @property
    def state_lock(self) -> threading.Condition:
        """The stream's (reentrant) state lock.  The session holds it
        across ``GraphBuilder.add`` + :meth:`admit`: node linkage
        (``deps``/``dependents`` sets) is mutated by admission and
        iterated by completion, so both must serialize here — admission
        order also stays equal to node order for free."""
        return self._cv

    def admit(self, node: TaskNode) -> None:
        """Wire one freshly built node into the live stream.  The caller
        (the session) serializes builder ``add`` + ``admit`` so node
        indices equal admission order.  Scheduling errors (unknown pin,
        op with no eligible PE) fail the node — they surface through its
        futures, like every other failure."""
        with self._cv:
            if self._closed:
                raise RuntimeError("stream executor is closed")
            assert node.index == self._admitted, "admission out of order"
            self._nodes.append(node)
            self._admitted += 1
            if self.scheduler == "round_robin":
                # Static placement at admission (submission order), so a
                # single-threaded stream is bit-identical to serial
                # dispatch — same contract as batch round_robin.
                try:
                    self._static_pe[node.index] = self.rt._schedule(node.task)
                except BaseException as e:
                    self._fail_node(node.index, e, root=True)
                    return
            failed_dep = next(
                (d for d in node.deps if d in self._failed), None)
            if failed_dep is not None:
                self._fail_node(node.index, self._failed[failed_dep],
                                root=False)
                return
            live = sum(1 for d in node.deps if d not in self._completed)
            self._remaining[node.index] = live
            if live == 0:
                self._dispatch([node.index])

    def _dispatch(self, indices: List[int]) -> None:
        """Assign + enqueue ready nodes (under the stream lock).  HEFT
        ranks the batch over the admitted-incomplete window first;
        prefetch stagings are issued least-contended-route-first."""
        nodes, ctx = self._nodes, self.rt.context
        if self.scheduler == "heft" and len(indices) > 1:
            self._rank_window()
            indices = sorted(indices, key=lambda i: -nodes[i].rank)
        if self.scheduler == "heft":
            # Cross-client interference: expose the batch's
            # still-unplaced tasks (with client attribution) so each
            # placement can charge the delay it imposes on other
            # clients' ready work.
            self._copending = {
                i: (nodes[i].task.client,
                    self._eligible_names(nodes[i].task))
                for i in indices if nodes[i].task.client is not None
            }
        assigned: List[Tuple[int, "PE"]] = []
        cap = 4 * max(self.window, 16)
        for i in indices:
            node = nodes[i]
            self._copending.pop(i, None)  # never charge a task for itself
            try:
                pe = self._static_pe.pop(i, None) or self._pick_pe(node)
            except BaseException as e:
                self._fail_node(i, e, root=True)
                continue
            # Bound the slot-search state for unbounded streams: drop the
            # oldest committed intervals once the list outgrows the
            # scheduling window.  Exposed "past" gaps only loosen the EFT
            # heuristic for late-admitted roots — placement quality, not
            # correctness — and keep per-placement cost O(window), not
            # O(stream length).
            busy = self._pe_slots[pe.name]
            if len(busy) > cap:
                del busy[: len(busy) - cap // 2]
            for hd in node.task.inputs:
                ctx.protect(hd, pe.location)
            assigned.append((i, pe))
        self._copending = {}
        futs: Dict[int, Future] = {}
        if self.prefetch:
            for i, pe in self._prefetch_order(assigned):
                futs[i] = self._pool.transfer.submit(
                    self._prefetch_stage, nodes[i].task, pe
                )
        for i, pe in assigned:
            self._pool.submit(self, pe.name, (i, pe, futs.get(i)))

    def _rank_window(self) -> None:
        """Recompute HEFT upward ranks over the admitted, incomplete
        window — the streaming analogue of whole-graph ranking: later
        admissions extend the DAG, so ranks are re-derived from what is
        known now.  ``window`` bounds the scan to the most recent
        admissions (older incomplete stragglers keep their last rank)."""
        rt, cm = self.rt, self.rt.cost_model
        bw = rt.context.ledger.bandwidth_model
        lo = max(0, self._admitted - self.window) if self.window else 0
        live = [
            n for n in self._nodes[lo:]
            if n.index not in self._completed and n.index not in self._failed
        ]
        for n in reversed(live):  # deps point backward: reverse = leaves first
            succ = max(
                (bw.typical(self._nodes[s].task.in_bytes)
                 + self._nodes[s].rank
                 for s in n.dependents if s not in self._completed),
                default=0.0,
            )
            try:
                kinds = sorted({pe.kind for pe in rt._eligible(n.task)})
            except LookupError:
                kinds = []
            n.rank = cm.mean_estimate(n.task.op, kinds, n.task.in_bytes) + succ

    # -- workers ------------------------------------------------------------
    def _process(self, pe: "PE", payload: tuple) -> None:
        """Execute one payload on its PE worker thread.  Unlike the
        batch engine, a peer's failure does not drain the stream — only
        the failing task's dependent subtree is failed."""
        i, pe_assigned, fut = payload
        if self._closed:
            self._abandon(payload)
            return
        node = self._nodes[i]
        try:
            result = _execute_task(self.rt, node.task, pe_assigned, fut)
        except BaseException as e:
            self._unprotect(node, pe_assigned)
            with self._cv:
                self._fail_node(i, e, root=True)
            return
        self._unprotect(node, pe_assigned)
        self._complete(node, pe_assigned, *result)

    def _fail_node(self, i: int, exc: BaseException, *, root: bool) -> None:
        """Mark node ``i`` failed and cascade to its admitted dependent
        subtree (same root cause) — iterative worklist, so an arbitrarily
        deep chain cannot overflow the stack on a worker thread.  Called
        under the stream lock."""
        if i in self._failed or i in self._completed:
            return
        self._failed[i] = exc
        if root:
            self._unobserved.append(i)
        ledger = self.rt.context.ledger
        tracer = self.rt.context.tracer
        work = [i]
        while work:
            j = work.pop()
            self._remaining.pop(j, None)
            ledger.record_client_failure(self._nodes[j].task.client)
            if tracer is not None:
                client = self._nodes[j].task.client
                tracer.instant(
                    "task_failed", "error",
                    f"tenant:{client}" if client else "stream",
                    {"node": j, "task": self._nodes[j].name,
                     "root": j == i, "error": type(exc).__name__})
            if self._on_done is not None:
                self._on_done(j, exc)
            for s in sorted(self._nodes[j].dependents):
                if s not in self._failed and s not in self._completed:
                    self._failed[s] = exc
                    work.append(s)
        self._cv.notify_all()

    def _complete(self, node: TaskNode, pe: "PE", w0: float, w1: float,
                  tr_s: float, spill_s: float, comp_s: float, out_s: float,
                  moves: Sequence[tuple]) -> None:
        rt = self.rt
        with self._cv:
            # Online schedule simulation — same arithmetic as the batch
            # engine, so modeled makespans stay directly comparable.
            ready_m = self._ready_m(node)
            comp_m = rt.cost_model.prior_estimate(
                node.task.op, pe.kind, node.task.in_bytes
            )
            stage_s = tr_s + spill_s
            compute_start_m = max(self._pe_model[pe.name], ready_m + stage_s)
            finish_m = compute_start_m + comp_m + out_s
            self._pe_model[pe.name] = finish_m
            self._model_finish[node.index] = finish_m
            self.timeline.add(TimelineEvent(
                task=node.name, pe=pe.name,
                wall_start=w0 - self._t0, wall_end=w1 - self._t0,
                model_start=max(ready_m, compute_start_m - stage_s),
                model_end=finish_m,
                transfer_s=tr_s, compute_s=comp_s, out_transfer_s=out_s,
                spill_s=spill_s, compute_start_m=compute_start_m,
                node=node.index,
            ))
            rt.task_log.append((node.name, pe.name))
            self._records[node.index] = (
                pe.name, tuple(moves), comp_m, spill_s, out_s, tr_s,
                comp_s, w0 - self._t0, w1 - self._t0,
            )
            # Per-tenant service accounting: the modeled
            # seconds this task consumed, on the same basis as the
            # makespan simulation — fairness_report sums these.
            rt.context.ledger.record_client_task(
                node.task.client, node.task.in_bytes,
                tr_s + spill_s + comp_m + out_s,
            )
            self._completed.add(node.index)
            self._remaining.pop(node.index, None)
            newly_ready: List[int] = []
            for s in node.dependents:
                if s in self._remaining:
                    self._remaining[s] -= 1
                    if self._remaining[s] == 0:
                        newly_ready.append(s)
            if self._on_done is not None:
                self._on_done(node.index, None)
            if newly_ready:
                self._dispatch(sorted(newly_ready))
            self._cv.notify_all()

    # -- sync points --------------------------------------------------------
    def _quiesced(self) -> bool:
        return len(self._completed) + len(self._failed) >= self._admitted

    def barrier(self, timeout: Optional[float] = None) -> None:
        """Wait until every admitted task completed or failed, then
        re-raise the first unobserved root failure (submission order).
        Failures already raised through a future's ``result()`` are not
        raised again."""
        with self._cv:
            if not self._cv.wait_for(self._quiesced, timeout):
                raise TimeoutError(
                    f"stream barrier timed out after {timeout}s with "
                    f"{self._admitted - len(self._completed) - len(self._failed)}"
                    f" tasks in flight"
                )
            if self._unobserved:
                first = min(self._unobserved)
                self._unobserved.clear()
                raise self._failed[first]

    def wait(self, index: int, timeout: Optional[float] = None) -> None:
        """Block until node ``index`` completes or fails; raise its
        failure (marking it observed)."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: index in self._completed or index in self._failed,
                timeout,
            )
            if not ok:
                raise TimeoutError(f"task #{index} still pending "
                                   f"after {timeout}s")
            exc = self._failed.get(index)
        if exc is not None:
            self.mark_observed(index)
            raise exc

    def done(self, index: int) -> bool:
        with self._cv:
            return index in self._completed or index in self._failed

    def exception(self, index: int) -> Optional[BaseException]:
        with self._cv:
            return self._failed.get(index)

    def mark_observed(self, index: int) -> None:
        """The caller saw this node's failure (e.g. via a future's
        ``result()``): a later barrier will not re-raise it.  Observing
        a cascaded failure observes its root cause too — the exception
        object is the same one."""
        with self._cv:
            exc = self._failed.get(index)
            self._unobserved = [
                i for i in self._unobserved
                if i != index and self._failed[i] is not exc
            ]

    def close(self) -> None:
        """Drain the stream (wait for quiescence), then stop accepting
        admissions and reap any abandoned queue items.  Idempotent; does
        not raise pending failures — :meth:`barrier` does."""
        with self._cv:
            if self._closed:
                return
            self._cv.wait_for(self._quiesced)
            self._closed = True
        for payload in self._pool.drain(self):
            self._abandon(payload)

    @property
    def closed(self) -> bool:
        """The stream no longer accepts admissions — explicitly closed,
        or its worker pool was shut down (a task enqueued onto a dead
        pool would hang forever; the session raises
        ``SessionClosedError`` instead)."""
        return self._closed or self._pool.closed

    # -- reporting ----------------------------------------------------------
    def replay(self, admission=None):
        """Deterministic re-simulation of everything completed so far —
        call at a sync point for exact, machine-independent modeled
        metrics.  Without ``admission`` this is :func:`replay_schedule`
        (returns ``(timeline, makespan)``); with a
        :class:`~repro_torch.core.qos.QoSManager` (or its ``params()`` dict)
        it is the QoS-aware :func:`~repro_torch.core.qos.fair_replay`, which
        re-enacts per-client windows and DRR admission in virtual time
        and returns ``(timeline, makespan, finish, release)``."""
        with self._cv:
            records = dict(self._records)
            # Snapshot node linkage: later admissions keep mutating the
            # live nodes' dependent sets while the replay walks them.
            snap = [
                TaskNode(n.index, n.task, set(n.deps), set(n.dependents))
                for n in self._nodes
            ]
        if admission is None:
            return replay_schedule(self.rt, snap, records, self._topo)
        from .qos import fair_replay  # local import: hete imports qos

        return fair_replay(self.rt, snap, records, self._topo, admission)

    def report(self) -> Dict[str, Any]:
        """Schedule evidence for the stream so far.  ``makespan_model``
        and ``timeline`` come from the deterministic replay."""
        timeline, makespan = self.replay()
        per_pe: Dict[str, float] = {}
        for ev in timeline.events():
            per_pe[ev.pe] = per_pe.get(ev.pe, 0.0) + (
                ev.model_end - ev.model_start)
        with self._cv:
            admitted, completed = self._admitted, len(self._completed)
            failed = len(self._failed)
        ledger = self.rt.context.ledger
        return {
            "wall_s": time.perf_counter() - self._t0,
            "makespan_model": makespan,
            "n_tasks": admitted,
            "n_completed": completed,
            "n_failed": failed,
            "scheduler": self.scheduler,
            "policy": self.rt.policy,
            "backend": self.rt.backend,
            # placement cost source: measured calibration cells when a
            # table is attached, BASE_THROUGHPUT priors otherwise
            "calibrated": self.rt.calibration is not None,
            "calibration_cells": (
                len(self.rt.calibration)
                if self.rt.calibration is not None else 0),
            "prefetch": self.prefetch,
            "topology": self._topo.name if self._topo is not None else None,
            "per_pe_busy_model_s": per_pe,
            "timeline": timeline,
            "spill_stall_model_s": timeline.total_spill_s,
            "evictions": ledger.total_evictions,
            "prefetch_deferrals": ledger.prefetch_deferrals,
        }
