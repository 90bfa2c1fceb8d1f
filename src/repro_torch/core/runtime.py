"""Task runtime — the CEDR analogue RIMMS integrates with (§2, §3.2.2).

A small dynamic task runtime: applications submit *API calls* (tasks) over
:class:`~repro_torch.core.hete.HeteData` buffers; a scheduler maps each task to a
processing element (PE) at dispatch time (round-robin, pinned,
data-affinity, or transfer-aware HEFT-lite); the memory policy decides
what data movement happens.

Two memory policies, both first-class so every experiment reports the pair:

* ``"reference"`` — the paper's baseline (host-owned data): every input is
  copied host→PE before execution and every output PE→host after, so the
  host always holds the valid copy (Fig 1a).
* ``"rimms"``     — the paper's contribution: per-input last-resource-flag
  check, direct src→PE copy only when the flag names another location,
  output flag update to the executing PE (Fig 1b).

The **primary public entry point is the streaming session API**
(:mod:`repro_torch.core.api`): ``@rimms.op``-registered kernels,
``Session.malloc``/``Session.submit`` returning
:class:`~repro_torch.core.api.BufferFuture` handles, and the persistent
:class:`~repro_torch.core.executor.StreamExecutor` consuming the task stream
continuously.  This class is the **dispatch engine behind it** — the
session drives the same stage → execute → commit pipeline, scheduler
cost bases, and kernel registry defined here.

Two batch execution modes are kept as thin compat wrappers over that
pipeline:

* :meth:`Runtime.run` — serial, submission order (CEDR's API-level
  serialization);
* :meth:`Runtime.run_graph` — the batch task-graph executor
  (:class:`~repro_torch.core.executor.GraphExecutor`): automatic DAG
  construction, one worker per PE, input prefetch overlapping transfers
  with compute.

A "cpu" PE executes numpy callables against host memory; accelerator PEs
("fft_acc", "zip_acc", "gpu") execute torch callables — the hand-written
CUDA kernels — against their own
:class:`~repro_torch.core.hete.MemorySpace`, whose payloads are tensors on
a CUDA device (or CPU tensors when the caller asks for the CPU).
Transfers between spaces are real copies and are recorded in the ledger
(count, bytes, modeled seconds under platform bandwidths).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .graph import CostModel
from .hete import HeteContext, HeteData, MemorySpace, tensor_egress, tensor_ingest
from .instrument import Timeline, TimelineEvent
from .locations import HOST, Location
from .telemetry import DivergenceMonitor

__all__ = ["PE", "Task", "Runtime", "make_emulated_soc", "resolve_device",
           "sync_cuda", "SCHEDULERS",
           "BACKENDS", "resolve_backend", "register_platform",
           "platform_names"]

# ---------------------------------------------------------------------------
# Execution backends — one knob, threaded everywhere
# ---------------------------------------------------------------------------

#: valid values for the ``backend=`` knob (Session / Session.emulated /
#: Runtime / make_emulated_soc / benchmarks).
BACKENDS = ("thread", "process", "auto")


def resolve_backend(backend: Optional[str]) -> str:
    """Validate + resolve a backend name to ``"thread"`` or ``"process"``.

    ``None`` means thread (the historical default).  ``"auto"`` picks the
    process backend when real parallelism is available — more than one
    CPU core, or more than one CUDA device — and thread otherwise."""
    if backend is None:
        return "thread"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}: choose one of {BACKENDS}")
    if backend == "auto":
        if (os.cpu_count() or 1) > 1 or torch.cuda.device_count() > 1:
            return "process"
        return "thread"
    return backend


# ---------------------------------------------------------------------------
# Platform-preset shorthand registry
# ---------------------------------------------------------------------------

# name -> (topology_factory(dev_locs) -> Topology | None, arena_bytes | None)
_PLATFORMS: Dict[str, tuple] = {}


def register_platform(name: str, topology_factory: Optional[Callable] = None,
                      arena_bytes: Optional[int] = None, *,
                      replace: bool = False) -> None:
    """Register a platform preset so ``Session.emulated("name")`` (and
    ``make_emulated_soc(topology="name")``) resolves it.

    ``topology_factory(dev_locs)`` returns the
    :class:`~repro_torch.core.topology.Topology` for the platform's device
    locations (``None`` keeps the scalar bandwidth model);
    ``arena_bytes`` is the preset's default per-accelerator arena
    capacity (callers may still override it).  Built-in presets mirror
    :data:`repro_torch.core.topology.PRESETS`; re-registering a name raises
    unless ``replace=True``."""
    _register_builtin_platforms()
    if not replace and name in _PLATFORMS:
        raise ValueError(f"platform {name!r} already registered "
                         f"(pass replace=True to override)")
    _PLATFORMS[name] = (topology_factory, arena_bytes)


def platform_names() -> Tuple[str, ...]:
    """Registered platform preset names (built-ins + user presets)."""
    _register_builtin_platforms()
    return tuple(sorted(_PLATFORMS))


def _resolve_platform(name: str):
    """The registry entry for ``name`` or None (fall through to the raw
    topology presets for back-compat)."""
    _register_builtin_platforms()
    return _PLATFORMS.get(name)


def _register_builtin_platforms() -> None:
    # Lazy (first use), so importing this module never imports topology.
    from .topology import PRESETS, build_preset

    for preset in PRESETS:
        _PLATFORMS.setdefault(
            preset,
            (lambda locs, _p=preset: build_preset(_p, locs), 64 << 20),
        )

SCHEDULERS = ("round_robin", "data_affinity", "heft")


@dataclasses.dataclass
class PE:
    """A processing element: name, kind, its memory location, supported ops."""

    name: str
    kind: str  # "cpu" | "acc" | "gpu" | ...
    location: Location
    supports: frozenset

    def __post_init__(self) -> None:
        self.supports = frozenset(self.supports)


@dataclasses.dataclass
class Task:
    """One API call: op over HeteData inputs/outputs (+ scalar params)."""

    op: str
    inputs: List[HeteData]
    outputs: List[HeteData]
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    pin: Optional[str] = None  # pin to a PE name (CPU-ACC style scenarios)
    name: str = ""
    # submitting session client: per-tenant accounting +
    # cross-client interference-aware placement key on it
    client: Optional[str] = None

    @property
    def in_bytes(self) -> int:
        return sum(hd.nbytes for hd in self.inputs)

    @property
    def out_bytes(self) -> int:
        return sum(hd.nbytes for hd in self.outputs)


class Runtime:
    """Dispatch loop: schedule → move (policy) → execute → flag update."""

    def __init__(
        self,
        pes: Sequence[PE],
        context: HeteContext,
        *,
        policy: str = "rimms",
        scheduler: str = "round_robin",
        cost_model: Optional[CostModel] = None,
        backend: Optional[str] = None,
    ) -> None:
        if policy not in ("rimms", "reference"):
            raise ValueError(f"unknown memory policy {policy!r}")
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}")
        #: "thread" (in-process kernels) or "process" (subprocess PE
        #: workers for host-payload PEs); "auto" resolves here.
        self.backend = resolve_backend(backend)
        self.pes = list(pes)
        self.by_name = {pe.name: pe for pe in self.pes}
        self.context = context
        self.policy = policy
        self.scheduler = scheduler
        self.cost_model = cost_model or CostModel()
        # Measured-vs-modeled divergence: every compute/stage
        # execution pairs its wall duration with the cost model's prior
        # into per-(op, PE kind, shape bucket) ratio cells — surfaced in
        # Session.qos_report()["divergence"] and bench JSON records.
        self.divergence = DivergenceMonitor()
        self._rr_state: Dict[str, int] = {}
        # kernels: (op, pe_kind) -> callable(list_of_arrays, **params) -> tuple
        self._kernels: Dict[tuple, Callable] = {}
        # tuned kernel variants: (op, pe_kind, variant name)
        # -> (callable, bound launch params) — dispatched when an
        # attached calibration table names a winner for the shape bucket
        self._variant_kernels: Dict[tuple, Tuple[Callable, dict]] = {}
        #: attached CalibrationTable (None = default dispatch + priors)
        self.calibration = None
        #: non-default variant dispatches, (op, pe kind, variant) per
        #: call — outputs are bit-identical by construction, so tests
        #: and benches assert selection through this log
        self.variant_log: List[tuple] = []
        self.task_log: List[tuple] = []  # (task name/op, pe name) for tests
        self.timeline = Timeline()  # replaced per run/run_graph
        self.last_makespan_model = 0.0
        self.last_report: Optional[Dict[str, Any]] = None  # set by run_graph
        # persistent per-PE worker pool, created lazily by run_graph and
        # reused across calls; close() releases it
        self._worker_pool = None
        # per-PE subprocess workers, created lazily on the first
        # process-dispatched kernel; close() reaps them
        self._process_pool = None

    def set_backend(self, backend: Optional[str]) -> str:
        """Re-resolve the execution backend (e.g. a Session adopting this
        runtime with an explicit ``backend=``).  Returns the resolved
        name; an unknown name raises listing the valid choices."""
        if backend is not None:
            self.backend = resolve_backend(backend)
        return self.backend

    def _get_worker_pool(self):
        from .executor import WorkerPool  # local import: avoids cycle

        if self._worker_pool is None:
            pool = WorkerPool(self.pes)
            self._worker_pool = pool
            # release the pool's threads when this Runtime is collected
            self._pool_finalizer = weakref.finalize(
                self, WorkerPool.shutdown, pool
            )
        return self._worker_pool

    def _get_process_pool(self):
        from .pworker import ProcessWorkerPool  # local import: avoids cycle

        if self._process_pool is None:
            pool = ProcessWorkerPool()
            self._process_pool = pool
            # reap subprocesses when this Runtime is collected
            self._ppool_finalizer = weakref.finalize(
                self, ProcessWorkerPool.shutdown, pool
            )
        return self._process_pool

    def close(self) -> None:
        """Release the persistent worker pool and reap every PE worker
        subprocess (idempotent)."""
        if self._worker_pool is not None:
            self._pool_finalizer.detach()
            self._worker_pool.shutdown()
            self._worker_pool = None
        if self._process_pool is not None:
            self._ppool_finalizer.detach()
            self._process_pool.shutdown()
            self._process_pool = None

    def reset_stats(self) -> None:
        """Clear per-run diagnostics and dispatch state: the task log,
        round-robin rotation, timeline, and last modeled makespan/report.
        Called at the start of every :meth:`run`/:meth:`run_graph`, so
        repeated batch runs neither accumulate log entries nor leak
        round-robin placement state across runs —
        ``task_log`` after a run is exactly that run's placements, and
        identical task lists place identically on every run.  Streaming
        sessions deliberately do *not* reset between barriers: the
        stream is one continuous run."""
        self.task_log = []
        self.variant_log = []
        self._rr_state = {}
        self.timeline = Timeline()
        self.last_makespan_model = 0.0
        self.last_report = None

    # -- registration -------------------------------------------------------
    def register_kernel(self, op: str, pe_kind: str, fn: Callable, *,
                        variant: Optional[str] = None,
                        params: Optional[Dict[str, Any]] = None) -> None:
        """Register a kernel.  Without ``variant`` this is the op's
        default (reference) kernel — the historical behavior every call
        site relies on.  With ``variant`` it is a tuned candidate:
        ``params`` are its launch parameters, merged *under*
        per-task params at dispatch; it only runs when the attached
        calibration table names it the winner for the task's shape
        bucket."""
        if variant is None:
            self._kernels[(op, pe_kind)] = fn
        else:
            self._variant_kernels[(op, pe_kind, variant)] = (
                fn, dict(params or {}))

    def set_calibration(self, table) -> None:
        """Attach a :class:`~repro_torch.core.calibrate.CalibrationTable`:
        the cost model prices from its measured cells
        (:meth:`CostModel.set_calibration
        <repro_torch.core.graph.CostModel.set_calibration>`) and
        :meth:`_run_kernel` dispatches its winning variants.  ``None``
        detaches (default priors + default kernels)."""
        self.calibration = table
        self.cost_model.set_calibration(table)

    # -- scheduling -----------------------------------------------------------
    def _eligible(self, task: Task) -> List[PE]:
        pes = [
            pe
            for pe in self.pes
            if task.op in pe.supports and (task.op, pe.kind) in self._kernels
        ]
        if not pes:
            raise LookupError(f"no PE supports op {task.op!r}")
        return pes

    def _schedule(self, task: Task) -> PE:
        if task.pin is not None:
            return self.by_name[task.pin]
        pes = self._eligible(task)
        if self.scheduler == "round_robin":
            i = self._rr_state.get(task.op, 0)
            self._rr_state[task.op] = (i + 1) % len(pes)
            return pes[i % len(pes)]
        if self.scheduler == "heft":
            # Transfer-aware greedy pick: minimize modeled staging cost +
            # estimated compute (per-PE availability is the executor's
            # refinement; serial dispatch has no queues to account for).
            return min(pes, key=lambda pe: (sum(self._heft_costs(task, pe)),
                                            pe.name))
        # data_affinity (beyond-paper)
        return self._affinity_pick(task, pes)

    def _affinity_pick(self, task: Task, pes: Sequence[PE]) -> PE:
        """Most input bytes already valid at the PE; ties broken by stable
        PE-name ordering (deterministic).  Shared by serial dispatch and
        the graph executor."""
        def score(pe: PE) -> int:
            return sum(
                hd.nbytes for hd in task.inputs if hd.last_location == pe.location
            )
        return min(pes, key=lambda pe: (-score(pe), pe.name))

    def _heft_costs(self, task: Task, pe: PE) -> Tuple[float, float]:
        """(modeled input-transfer seconds, estimated compute seconds) for
        placing ``task`` on ``pe`` — the shared EFT cost basis for serial
        heft dispatch and the graph executor's placement."""
        bw = self.context.ledger.bandwidth_model
        tr = sum(
            bw.seconds(hd.last_location, pe.location, hd.nbytes)
            for hd in task.inputs
            if hd.last_location != pe.location
        )
        return tr, self.cost_model.estimate(task.op, pe.kind, task.in_bytes)

    # -- stage → execute → commit (shared by serial and graph modes) ---------
    def _pin_inputs(self, task: Task, loc: Location) -> None:
        """Hard-pin every input's root at ``loc`` so eviction triggered by
        a concurrent (or this task's own output) reservation can never
        spill bytes the kernel is about to read.  Balanced by
        :meth:`_unpin_inputs` after commit."""
        for hd in task.inputs:
            self.context.pin(hd, loc)

    def _unpin_inputs(self, task: Task, loc: Location) -> None:
        for hd in task.inputs:
            self.context.unpin(hd, loc)

    def _stage_inputs(
        self, task: Task, pe: PE, *, prefetch: bool = False
    ) -> Tuple[List[Any], float, float, List[tuple]]:
        """Materialize ``task``'s inputs at ``pe`` under the memory policy.
        Returns (input values, modeled transfer seconds, modeled seconds
        stalled on eviction write-backs, list of performed copies as
        ``(src, dst, nbytes)`` — the executor's topology replay re-prices
        these under per-link contention).

        Demand mode (default): inputs stay hard-pinned at ``pe`` until
        :meth:`_unpin_inputs` — callers release after commit.  Only one
        PE worker reserves per arena, so pinned bytes are bounded by one
        task's working set.

        Prefetch mode: *speculative warming* — runs under the context's
        prefetch guard (raises :class:`~repro_torch.core.hete.PrefetchDeferred`
        instead of evicting pinned/protected bytes) and takes NO pins, so
        concurrent prefetches can never starve the demand path.  The PE
        worker re-stages authoritatively before executing: a free flag
        hit when the warmed bytes survived, a re-fetch if pressure
        evicted them in between."""
        ctx, loc = self.context, pe.location
        ins: List[Any] = []
        model_s = 0.0
        ctx.take_spill_seconds()  # clear this thread's residue
        ctx.take_moves()  # arm + clear this thread's move log
        moves: List[tuple] = []
        if not prefetch:
            self._pin_inputs(task, loc)
        try:
            if self.policy == "reference":
                # Host-owned: host is current (producer wrote host under
                # this policy); copy host→PE unconditionally.
                for hd in task.inputs:
                    with hd.lock:
                        host_val = hd.copies[HOST]
                        if loc != HOST:
                            moved = ctx.spaces[loc].ingest(host_val)
                            model_s += ctx.record_copy(HOST, loc, hd.nbytes)
                            moves.append((HOST, loc, hd.nbytes))
                            ins.append(moved)
                        else:
                            ins.append(host_val)
            else:  # rimms: flag check + direct src→PE copy when needed
                guard = (ctx.prefetch_guard() if prefetch
                         else contextlib.nullcontext())
                with guard:
                    for hd in task.inputs:
                        value, tr_s = ctx.stage(hd, loc)
                        ins.append(value)
                        model_s += tr_s
                moves = ctx.take_moves()
        except BaseException:
            if not prefetch:
                self._unpin_inputs(task, loc)
            raise
        return ins, model_s, ctx.take_spill_seconds(), moves

    def _proc_eligible(self, pe: PE) -> bool:
        """Whether ``pe``'s kernels may execute in a subprocess worker:
        its memory space must hold host-format payloads (see
        :attr:`~repro_torch.core.hete.MemorySpace.proc_exec`) — PEs whose
        space holds CUDA tensors keep in-process dispatch."""
        space = self.context.spaces.get(pe.location)
        return space is not None and getattr(space, "proc_exec", False)

    def _run_kernel(self, task: Task, pe: PE, ins: List[Any]) -> Tuple[tuple, float]:
        """Execute the kernel; returns (outputs, measured seconds).  Waits
        for the CUDA stream of every CUDA output (kernels launch
        asynchronously) so timings feed the cost model honestly.

        Backend dispatch: under ``backend="process"`` the call runs on
        ``pe``'s subprocess worker — shared-memory inputs map zero-copy,
        the parent thread blocks GIL-free on the reply — for every PE
        whose space holds host payloads; other PEs (spaces on a CUDA
        device) execute in-process as before."""
        if self.backend == "process" and self._proc_eligible(pe):
            outs, dt = self._run_kernel_process(task, pe, ins)
        else:
            fn, params, _ = self._select_kernel(task, pe)
            t0 = time.perf_counter()
            outs = _as_tuple(fn(ins, **params))
            sync_cuda(outs)
            dt = time.perf_counter() - t0
            self.cost_model.observe(task.op, pe.kind, task.in_bytes, dt)
        self.divergence.observe(
            "compute", task.op, pe.kind, task.in_bytes, dt,
            self.cost_model.prior_estimate(task.op, pe.kind, task.in_bytes))
        return outs, dt

    def _select_kernel(self, task: Task, pe: PE) -> Tuple[Callable, dict, str]:
        """Variant-aware kernel lookup: the attached
        calibration table's winning variant for the task's shape bucket
        when it is registered (bit-identical to the default by the
        autotuner's eligibility bar), else the default kernel.  Returns
        ``(fn, merged params, variant name)`` — per-task params override
        the variant's bound launch params.  Non-default selections are
        appended to :attr:`variant_log`."""
        if self.calibration is not None:
            vname = self.calibration.best_variant(task.op, pe.kind,
                                                  task.in_bytes)
            if vname is not None:
                entry = self._variant_kernels.get((task.op, pe.kind, vname))
                if entry is not None:
                    fn, vparams = entry
                    self.variant_log.append((task.op, pe.kind, vname))
                    return fn, {**vparams, **task.params}, vname
        return self._kernels[(task.op, pe.kind)], dict(task.params), "default"

    def _run_kernel_process(self, task: Task, pe: PE,
                            ins: List[Any]) -> Tuple[tuple, float]:
        """Process-backend kernel call: ship handles to ``pe``'s worker,
        forward the worker-measured compute span onto the trace (on the
        ``pe:{name}:worker`` track, clock-offset corrected and clamped to
        the parent-observed call window).  An accelerator PE's kernel is
        handed CPU tensors in the worker, as its space on the CPU holds
        them under the thread backend."""
        fn, params, vname = self._select_kernel(task, pe)
        key = (task.op, pe.kind, vname)
        worker = self._get_process_pool().worker(pe.name)
        worker.ensure_kernel(key, fn, as_tensor=pe.location != HOST)
        outs, w0, w1, k0, k1 = worker.run(key, ins, params)
        dt = w1 - w0
        self.cost_model.observe(task.op, pe.kind, task.in_bytes, dt)
        tracer = self.context.tracer
        if tracer is not None:
            tracer.forward_span(
                task.name or task.op, "compute", f"pe:{pe.name}:worker",
                k0, k1, lo=w0, hi=w1,
                args={"op": task.op, "backend": "process",
                      "worker_pid": worker.pid},
            )
        return outs, dt

    def _commit_outputs(self, task: Task, pe: PE, outs: tuple) -> Tuple[float, float]:
        """Flag updates (+ host writeback under reference). Returns
        (modeled output-transfer seconds, modeled eviction-stall seconds
        the output reservations caused)."""
        ctx, loc = self.context, pe.location
        model_s = 0.0
        ctx.take_spill_seconds()  # clear this thread's residue
        if self.policy == "reference":
            for hd, val in zip(task.outputs, outs):
                if loc != HOST:
                    host_val = ctx.spaces[loc].egress(val)
                    model_s += ctx.record_copy(loc, HOST, hd.nbytes)
                else:
                    host_val = np.asarray(val)
                ctx.mark_written(hd, HOST, host_val.reshape(hd.shape))
        else:
            for hd, val in zip(task.outputs, outs):
                ctx.mark_written(hd, loc, val)
        return model_s, ctx.take_spill_seconds()

    def _add_transfer_lanes(self, topo, task: Task, moves: Sequence[tuple],
                            start: float, node: int = -1) -> float:
        """Record per-link :class:`TransferEvent` lanes for ``moves``
        issued *concurrently* at modeled time ``start``, walking each
        copy's route through per-link busy-until contention: copies on
        disjoint routes overlap, copies sharing a
        link queue behind each other — and behind earlier tasks' traffic,
        since link state persists across the run.  This is exactly the
        pricing the graph executor's replay applies, so serial vs graph
        topology comparisons are apples-to-apples (previously serial
        summed uncontended store-and-forward hop times).  Returns the
        modeled staging duration (last byte delivered − ``start``)."""
        from .instrument import TransferEvent

        end_max = start
        for src, dst, nbytes in moves:
            _, end, hops = topo.transfer(src, dst, nbytes, at=start,
                                         commit=True)
            for link, hs, he in hops:
                self.timeline.add_transfer(TransferEvent(
                    link=link.label, task=task.name or task.op,
                    nbytes=nbytes, model_start=hs, model_end=he,
                    node=node,
                ))
            end_max = max(end_max, end)
        return end_max - start

    # -- execution --------------------------------------------------------------
    def run(self, tasks: Sequence[Task]) -> float:
        """Execute tasks serially in submission order (data deps are
        submission-ordered by the apps, matching CEDR's API-level
        serialization).  Returns wall seconds; fills :attr:`timeline` and
        :attr:`last_makespan_model` for comparison against graph mode.

        .. deprecated::
           Compat wrapper — prefer the streaming session API
           (:class:`repro_torch.core.api.Session`).  Emits one
           :class:`DeprecationWarning` per process; internal callers
           (the session, benchmarks' serial baselines) use
           :meth:`_run_impl` directly, so the warning always points at
           user code."""
        _warn_deprecated("run")
        return self._run_impl(tasks)

    def _run_impl(self, tasks: Sequence[Task]) -> float:
        """Serial dispatch body — the reference every equivalence/
        copy-count claim compares against (no deprecation warning)."""
        self.reset_stats()
        topo = getattr(self.context.ledger.bandwidth_model, "topology", None)
        if topo is not None:
            topo.reset_contention()
        tracer = self.context.tracer
        model_t = 0.0
        t0 = time.perf_counter()
        for node_i, task in enumerate(tasks):
            pe = self._schedule(task)
            w0 = time.perf_counter()
            ins, tr_s, sp_s, moves = self._stage_inputs(task, pe)
            w_staged = time.perf_counter()
            try:
                outs, comp_s = self._run_kernel(task, pe, ins)
                w_comp = time.perf_counter()
                out_s, sp2_s = self._commit_outputs(task, pe, outs)
            finally:
                self._unpin_inputs(task, pe.location)
            w1 = time.perf_counter()
            self.divergence.observe(
                "stage", task.op, pe.kind, task.in_bytes,
                w_staged - w0, tr_s + sp_s)
            if tracer is not None:
                tname = task.name or task.op
                targs = {"task": tname, "op": task.op, "node": node_i}
                tracer.span(tname, "stage", f"pe:{pe.name}:stage",
                            w0, w_staged, targs)
                tracer.span(tname, "compute", f"pe:{pe.name}",
                            w_staged, w_comp, targs)
                tracer.span(tname, "writeback", f"pe:{pe.name}",
                            w_comp, w1, targs)
            spill_s = sp_s + sp2_s
            stage_m = tr_s
            if topo is not None:
                # Routed transfer lanes over modeled time: this task's
                # copies issue concurrently at model_t and queue on
                # shared links (per-link contention, like graph replay).
                stage_m = self._add_transfer_lanes(topo, task, moves,
                                                   model_t, node=node_i)
            # Model simulation uses the static compute estimate so serial
            # and graph modeled makespans are directly comparable (see
            # CostModel.prior_estimate).  Spill stalls (eviction
            # write-backs under capacity pressure) extend the task's
            # modeled interval exactly like transfers do.
            comp_m = self.cost_model.prior_estimate(task.op, pe.kind, task.in_bytes)
            dur_m = stage_m + spill_s + comp_m + out_s
            self.timeline.add(TimelineEvent(
                task=task.name or task.op, pe=pe.name,
                wall_start=w0 - t0, wall_end=w1 - t0,
                model_start=model_t, model_end=model_t + dur_m,
                transfer_s=tr_s, compute_s=comp_s, out_transfer_s=out_s,
                spill_s=spill_s,
                compute_start_m=model_t + stage_m + spill_s, node=node_i,
            ))
            model_t += dur_m
            self.task_log.append((task.name or task.op, pe.name))
        self.last_makespan_model = model_t
        if tracer is not None:
            tracer.add_timeline(self.timeline, label="serial")
        return time.perf_counter() - t0

    def run_graph(
        self,
        tasks: Sequence[Task],
        *,
        scheduler: Optional[str] = None,
        prefetch: bool = True,
    ) -> float:
        """Execute ``tasks`` on the async task-graph executor: automatic
        RAW/WAR/WAW DAG, one worker per PE, input prefetch overlapping
        transfers with compute, and transfer-aware placement when
        ``scheduler='heft'``.  Same ledger and memory policies as
        :meth:`run`; under the ``rimms`` policy with static scheduling the
        copy counts and outputs are identical to serial execution.

        Returns wall seconds; :attr:`timeline`, :attr:`last_makespan_model`
        and :attr:`last_report` carry the schedule evidence.

        .. deprecated::
           Compat wrapper — prefer the streaming session API
           (:class:`repro_torch.core.api.Session`), which drives the same
           worker pool continuously.  Emits one
           :class:`DeprecationWarning` per process; internal callers use
           :meth:`_run_graph_impl`.
        """
        _warn_deprecated("run_graph")
        return self._run_graph_impl(tasks, scheduler=scheduler,
                                    prefetch=prefetch)

    def _run_graph_impl(
        self,
        tasks: Sequence[Task],
        *,
        scheduler: Optional[str] = None,
        prefetch: bool = True,
    ) -> float:
        """Batch graph-executor body (no deprecation warning)."""
        from .executor import GraphExecutor  # local import: avoids cycle

        self.reset_stats()
        ex = GraphExecutor(self, scheduler=scheduler, prefetch=prefetch)
        report = ex.run(tasks)
        self.last_report = report
        return report["wall_s"]


def _as_tuple(x: Any) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def sync_cuda(values: Sequence[Any]) -> None:
    """Wait for the current CUDA stream of every CUDA tensor in
    ``values`` (no-op for numpy arrays and CPU tensors)."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.current_stream(v.device).synchronize()


# One DeprecationWarning per process: the first
# Runtime.run / run_graph call warns, later ones stay quiet so batch
# loops don't flood stderr.
_deprecation_warned = False


def _warn_deprecated(which: str) -> None:
    global _deprecation_warned
    if _deprecation_warned:
        return
    _deprecation_warned = True
    warnings.warn(
        f"Runtime.{which}() is a compat wrapper and is deprecated; use the "
        f"streaming session API instead (repro_torch.core.api.Session / "
        f"Session.emulated — see the README migration table).",
        DeprecationWarning,
        stacklevel=3,
    )


# ---------------------------------------------------------------------------
# Emulated heterogeneous SoC (§4.1 analogue): the host space holds numpy,
# accelerator spaces hold torch tensors on a CUDA device.
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The torch device accelerator spaces live on.  ``None`` means
    CUDA and raises :class:`RuntimeError` when no CUDA device is
    available — the port never continues on the CPU unasked; pass
    ``device="cpu"`` to run on CPU tensors (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: repro_torch runs on the GPU "
                "unless asked for the CPU (pass device='cpu')")
        device = "cuda"
    return torch.device(device)


def make_emulated_soc(
    *,
    n_cpu: int = 1,
    accelerators: Sequence[str] = ("fft_acc0", "zip_acc0"),
    acc_ops: Optional[Dict[str, Sequence[str]]] = None,
    arena_bytes=64 << 20,  # 64 MiB UDMA buffer, as on the ZCU102
    allocator: str = "nextfit",
    block_size: int = 4096,
    context: Optional[HeteContext] = None,
    tracking: str = "flag",
    topology=None,
    backend: Optional[str] = None,
    device=None,
) -> tuple:
    """Build (runtime-ready PEs, HeteContext) for an emulated SoC.

    ``acc_ops`` maps accelerator name → ops it supports; defaults derive
    from the name prefix ("fft_acc*" → fft/ifft, "zip_acc*" → zip,
    "gpu*" → everything).

    ``arena_bytes`` is one capacity for every accelerator, or a dict
    ``{accelerator name: bytes}`` for asymmetric arenas (spill-to-peer
    scenarios need a roomy neighbour).

    ``topology`` opts into routed, contention-aware transfer modeling:
    a platform name from :func:`platform_names` (built-ins
    "emulated_soc", "pcie_tree", "nvlink_mesh", "host_bridged_fpga", plus
    anything the embedding app added via :func:`register_platform`), a
    :class:`~repro_torch.core.topology.Topology`, or a ready
    :class:`~repro_torch.core.topology.TopologyBandwidthModel`.  It replaces
    the context ledger's scalar bandwidth model; ``None`` (the default)
    keeps the scalar model, so existing baselines hold.

    ``device`` (see :func:`resolve_device`): ``None`` is CUDA, and then
    accelerator spaces are spread round-robin over the CUDA devices —
    with one card every space maps to ``cuda:0`` and keeps its own
    arena.  ``"cpu"`` gives every space CPU tensors.  Ingest and egress
    are real synchronous copies (:func:`~repro_torch.core.hete.tensor_ingest`,
    :func:`~repro_torch.core.hete.tensor_egress`).

    ``backend`` (see :func:`resolve_backend`): ``"thread"`` (default)
    keeps in-process kernels.  ``"process"`` builds the SoC for
    subprocess PE workers: host buffers come from a
    :class:`~repro_torch.core.shm.SharedHostArena` (capacity
    :func:`~repro_torch.core.shm.default_arena_bytes`) that workers map
    zero-copy, so every cpu PE runs in a worker.  With ``device="cpu"`` the accelerator spaces hold
    host-format numpy payloads too (distinct shared-memory copies; their
    arenas — capacity, eviction, the whole ledger — stay modeled exactly
    as before) and their PEs run in workers, which hand the kernels CPU
    tensors.  On CUDA the accelerator spaces keep their tensors and
    in-process dispatch (the card already runs asynchronously; a worker
    never creates a CUDA context).
    """
    backend = resolve_backend(backend)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    ctx = context or HeteContext(tracking=tracking)
    if backend == "process" and ctx.host_arena is None:
        from .shm import SharedHostArena, default_arena_bytes

        ctx.attach_host_arena(SharedHostArena(default_arena_bytes()))

    pes: List[PE] = []
    for i in range(n_cpu):
        pes.append(
            PE(f"cpu{i}", "cpu", HOST, frozenset({"fft", "ifft", "zip", "generic"}))
        )

    default_ops = {"fft_acc": ("fft", "ifft"), "zip_acc": ("zip",),
                   "gpu": ("fft", "ifft", "zip", "generic")}
    dev_locs: List[Location] = []
    for idx, name in enumerate(accelerators):
        kind = next((k for k in default_ops if name.startswith(k)), "acc")
        ops = tuple((acc_ops or {}).get(name, default_ops.get(kind, ())))
        loc = Location("device", name)
        dev_locs.append(loc)
        capacity = (
            arena_bytes.get(name, 64 << 20)
            if isinstance(arena_bytes, dict) else arena_bytes
        )
        if backend == "process" and dev.type == "cpu":
            # Subprocess workers execute this PE's kernels: device copies
            # are host-format (distinct shared-memory buffers — the
            # host→device copy is real, the arena stays modeled).
            ingest, egress, proc_exec = ctx.host_copy, np.asarray, True
        else:
            ingest = tensor_ingest(devices[idx % len(devices)])
            egress, proc_exec = tensor_egress, False
        ctx.register_space(
            MemorySpace(
                loc,
                capacity=capacity,
                allocator=allocator,
                block_size=block_size,
                ingest=ingest,
                egress=egress,
                proc_exec=proc_exec,
            )
        )
        pes.append(PE(name, "gpu" if kind == "gpu" else "acc", loc, frozenset(ops)))

    if topology is not None:
        from .topology import Topology, TopologyBandwidthModel, build_preset

        if isinstance(topology, str):
            entry = _resolve_platform(topology)
            if entry is not None and entry[0] is not None:
                topology = entry[0](dev_locs)
            else:
                topology = build_preset(topology, dev_locs)
        if isinstance(topology, Topology):
            topology = TopologyBandwidthModel(topology)
        ctx.ledger.bandwidth_model = topology
    return pes, ctx
