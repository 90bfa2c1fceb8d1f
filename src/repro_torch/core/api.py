"""Streaming session API — RIMMS's primary entry point.

The paper's promise (§3.2) is that application code names *work* and
*data* while the runtime owns placement, movement, and completion.  The
batch entry points (:meth:`Runtime.run` / :meth:`Runtime.run_graph`)
still made callers hand-assemble static ``Task`` lists, pick an
execution mode, and ``hete_sync`` by hand.  This module is the
redesigned front door:

* :func:`op` — decorator registering a kernel *variant per PE kind*
  into an :class:`OpRegistry` (``@rimms.op("fft", kinds=("cpu",))``);
  a session installs the registry into its runtime, so applications
  never call ``register_kernel`` directly;
* :class:`Session` — deferred execution over a **live task DAG**:
  :meth:`Session.malloc` and :meth:`Session.submit` return
  :class:`BufferFuture` handles, each submission incrementally extends
  the DAG (:class:`~repro_torch.core.graph.GraphBuilder` resolves RAW/WAR/WAW
  ordering from the buffers' read/write intervals), and the persistent
  :class:`~repro_torch.core.executor.StreamExecutor` consumes the stream
  continuously — windowed HEFT placement over the ready frontier, no
  global barrier;
* :class:`BufferFuture` — a handle over a ``hete_Data`` buffer version:
  ``future.result()`` / :meth:`Session.barrier` / ``with session:`` are
  the *only* sync points; kernel exceptions propagate through futures
  (a failure fails its dependent subtree, independent chains keep
  flowing); :meth:`BufferFuture.free` is ``hete_free`` deferred to
  after the stream's last use of the buffer.

Example::

    import numpy as np
    from repro_torch.core import api as rimms
    import repro_torch.apps.radar  # registers fft/ifft/zip kernel variants

    with rimms.Session.emulated(accelerators=("gpu0", "gpu1")) as s:
        x = s.malloc((1024,), np.complex64)
        x.data[:] = make_signal()
        f = s.submit("fft", [x])          # returns a BufferFuture
        y = s.submit("ifft", [f])         # chains without waiting
        out = y.result()                  # the only sync point

Threads may submit concurrently against one session (multi-tenant
streaming): submissions serialize at admission, placement and data
movement stay runtime-owned, and each client blocks only on its own
futures.

Multi-tenant QoS: every submission belongs to a *client* — an
explicit :meth:`Session.client` handle or an implicit per-thread one.
Each client has a bounded in-flight window (``submit`` blocks when it is
full, or raises :class:`~repro_torch.core.qos.BackpressureFull` under
``nowait=True``), waiting submissions are admitted by a weighted
deficit-round-robin (:class:`~repro_torch.core.qos.QoSManager`), device-arena
reservations can be quota'd per tenant
(:class:`~repro_torch.core.qos.QuotaExceeded` fails only the offending
tenant), and :meth:`Session.qos_report` /
:meth:`Session.fairness_report` expose deterministic per-client latency
and Jain's-index fairness evidence.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .calibrate import (DEFAULT_VARIANT, CalibrationTable,  # noqa: F401
                        resolve_calibration)
from .executor import StreamExecutor
from .graph import GraphBuilder
from .hete import HeteContext, HeteData
from .locations import HOST
from .qos import DEFAULT_CLIENT, BackpressureFull, QoSManager, admission_cost
from .runtime import (BACKENDS, Runtime, Task,  # noqa: F401
                      make_emulated_soc, platform_names, register_platform,
                      resolve_backend)
from .telemetry import Sampler, metrics_text, serve_metrics, slo_eval
from .trace import (MetricsRegistry, TraceCollector, trace,  # noqa: F401
                    trace_lint)

__all__ = ["OpRegistry", "OpVariant", "op", "default_registry",
           "BufferFuture", "Session", "SessionClient", "SessionClosedError",
           "CalibrationTable", "DEFAULT_VARIANT", "TraceCollector",
           "MetricsRegistry", "Sampler", "trace", "trace_lint", "BACKENDS",
           "resolve_backend", "register_platform", "platform_names"]


class SessionClosedError(RuntimeError):
    """The session is closed (explicitly, or by ``with`` exit): it no
    longer accepts ``malloc``/``submit``.  Raised instead of silently
    enqueueing onto a drained stream or a dead worker pool."""


@dataclasses.dataclass(frozen=True)
class OpVariant:
    """One registered kernel variant: the callable plus the launch
    params bound at registration (merged *under* per-task params at
    dispatch) and an optional calibration input factory
    ``(rng, nbytes) -> list[ndarray]`` the measurement harness uses."""

    op: str
    kind: str
    variant: str
    fn: Callable
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    calib: Optional[Callable] = None


class OpRegistry:
    """Kernel variants keyed on ``(op, pe_kind, variant)`` — the
    dispatch table the :func:`op` decorator fills and a :class:`Session`
    installs into its :class:`~repro_torch.core.runtime.Runtime`.

    A variant is ``fn(inputs: list, **params) -> array | tuple`` exactly
    like :meth:`Runtime.register_kernel` expects.  The **default**
    variant (no ``variant=`` at registration) keeps the historical
    single-registration behavior: registering the same ``(op, kind)``
    twice with a different function raises unless ``replace=True``
    (kernels are identity, not configuration) — and so does re-using a
    named variant.  Named variants are tuning candidates:
    same math, different launch parameters; the autotuner races them and
    :meth:`select` answers which one a calibration table says to run.
    """

    def __init__(self) -> None:
        # (op, kind) -> {variant name -> OpVariant}; DEFAULT_VARIANT is
        # the reference registration every current call site resolves.
        self._variants: Dict[Tuple[str, str], Dict[str, OpVariant]] = {}

    def register(self, op_name: str, kind: str, fn: Callable, *,
                 variant: Optional[str] = None,
                 params: Optional[Dict[str, Any]] = None,
                 calib: Optional[Callable] = None,
                 replace: bool = False) -> None:
        vname = variant or DEFAULT_VARIANT
        key = (op_name, kind)
        group = self._variants.setdefault(key, {})
        prev = group.get(vname)
        if prev is not None and prev.fn is not fn and not replace:
            raise ValueError(
                f"op variant {key + (vname,)} already registered "
                f"({prev.fn.__name__}); pass replace=True to override"
            )
        group[vname] = OpVariant(op_name, kind, vname, fn,
                                 dict(params or {}), calib)

    # -- default-variant fast path (every plain registration) ------------
    def get(self, op_name: str, kind: str) -> Optional[Callable]:
        var = self._variants.get((op_name, kind), {}).get(DEFAULT_VARIANT)
        return var.fn if var is not None else None

    def kinds(self, op_name: str) -> List[str]:
        """PE kinds with a registered variant of ``op_name``."""
        return sorted(k for (o, k) in self._variants if o == op_name)

    def ops(self) -> List[str]:
        return sorted({o for o, _ in self._variants})

    def __len__(self) -> int:
        return len(self._variants)

    # -- variant surface ------------------------------------------
    def variants(self, op_name: str, kind: str) -> List[str]:
        """Registered variant names for ``(op, kind)``, default first."""
        names = sorted(self._variants.get((op_name, kind), {}))
        if DEFAULT_VARIANT in names:
            names.remove(DEFAULT_VARIANT)
            names.insert(0, DEFAULT_VARIANT)
        return names

    def variant(self, op_name: str, kind: str, name: str) -> OpVariant:
        group = self._variants.get((op_name, kind), {})
        if name not in group:
            raise KeyError(
                f"no variant {name!r} of op {(op_name, kind)}; registered: "
                f"{self.variants(op_name, kind)}")
        return group[name]

    def select(self, op_name: str, kind: str, nbytes,
               table=None) -> OpVariant:
        """The variant to dispatch for ``nbytes`` of input (an int, or
        anything with ``.nbytes``): the calibration ``table``'s winner
        for this shape bucket when one is recorded and registered, else
        the default variant."""
        n = int(getattr(nbytes, "nbytes", nbytes))
        group = self._variants.get((op_name, kind), {})
        if table is not None:
            best = table.best_variant(op_name, kind, n)
            if best is not None and best in group:
                return group[best]
        var = group.get(DEFAULT_VARIANT)
        if var is None:
            raise KeyError(f"op {(op_name, kind)} has no default variant")
        return var

    def input_maker(self, op_name: str) -> Optional[Callable]:
        """The op's calibration input factory ``(rng, nbytes) ->
        list[ndarray]`` — taken from any variant that declared one
        (kind-independent: the same arrays feed every PE kind)."""
        for (o, _k), group in sorted(self._variants.items()):
            if o != op_name:
                continue
            for vname in sorted(group):
                if group[vname].calib is not None:
                    return group[vname].calib
        return None

    def install(self, rt: Runtime, *, missing_only: bool = False,
                extend_supports: Sequence[str] = ()) -> None:
        """Register every variant into ``rt``.  ``missing_only`` keeps
        kernels the runtime already has (so a session never clobbers a
        hand-registered override) — keyed on the default variant, with
        named variants of the op riding along.  ``extend_supports``
        names the *general-purpose* PE kinds (typically
        ``("cpu", "gpu")``) whose PEs additionally advertise every op
        they now have a kernel for — restricted accelerator kinds (a zip
        engine is a zip engine) keep the op sets their platform
        description declared."""
        for (op_name, kind), group in self._variants.items():
            if missing_only and (op_name, kind) in rt._kernels:
                continue
            for vname, var in group.items():
                if vname == DEFAULT_VARIANT:
                    rt.register_kernel(op_name, kind, var.fn)
                else:
                    rt.register_kernel(op_name, kind, var.fn,
                                       variant=vname, params=var.params)
        for pe in rt.pes:
            if pe.kind in extend_supports:
                extra = {o for (o, k) in self._variants if k == pe.kind}
                pe.supports = frozenset(pe.supports | extra)


#: process-default registry — the one bare ``@op`` fills and sessions
#: install unless given their own.
default_registry = OpRegistry()


def op(name: str, *, kinds: Union[str, Sequence[str]],
       registry: Optional[OpRegistry] = None,
       variant: Optional[str] = None,
       params: Optional[Dict[str, Any]] = None,
       calib: Optional[Callable] = None,
       replace: bool = False) -> Callable:
    """Decorator: register the function as op ``name``'s kernel variant
    for each PE kind in ``kinds``::

        @rimms.op("fft", kinds=("acc", "gpu"))
        def fft_device(ins):
            return _jfft(ins[0])

    Without ``variant=`` this is the op's **default** (reference)
    registration, with the historical duplicate-registration error.
    ``variant="block64", params={"block_rows": 64}`` registers a tuning
    candidate instead: same math as the default, launch
    ``params`` bound at dispatch, raced by the autotuner and selected
    per shape bucket from a calibration table.  ``calib`` attaches the
    op's calibration input factory ``(rng, nbytes) -> list[ndarray]`` so
    the measurement harness can synthesize representative inputs.

    The function is returned unchanged (still directly callable)."""
    kind_list = (kinds,) if isinstance(kinds, str) else tuple(kinds)
    if not kind_list:
        raise ValueError(f"op {name!r} needs at least one PE kind")

    def deco(fn: Callable) -> Callable:
        reg = registry if registry is not None else default_registry
        for k in kind_list:
            reg.register(name, k, fn, variant=variant, params=params,
                         calib=calib, replace=replace)
        return fn

    return deco


class BufferFuture:
    """A handle over a ``hete_Data`` buffer inside a streaming
    :class:`Session` — the session API's unit of data.

    Submitting a task that writes the buffer binds the returned future
    to the buffer's new *version* (:class:`~repro_torch.core.graph.GraphBuilder`
    bumps it per write submission).  :meth:`result` synchronizes the
    buffer: it waits for the buffer's last submitted writer (so a
    resubmitted buffer resolves to its newest submitted content), then
    returns the host-synced array.  A failed producing task — or a
    failed transitive dependency — re-raises its exception here.
    """

    __slots__ = ("session", "hete", "version", "node")

    def __init__(self, session: "Session", hete: HeteData, *,
                 version: int = 0, node: Optional[int] = None) -> None:
        self.session = session
        self.hete = hete
        self.version = version
        #: index of the producing task's node in the stream (None for a
        #: fresh malloc) — keys into the per-task ``finish``/``release``
        #: times of :meth:`Session.qos_report`
        self.node = node

    # -- buffer surface ------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return self.hete.shape

    @property
    def dtype(self) -> np.dtype:
        return self.hete.dtype

    @property
    def nbytes(self) -> int:
        return self.hete.nbytes

    @property
    def data(self) -> np.ndarray:
        """The raw host-resident field (paper semantics: reading it
        without :meth:`result` may observe stale bytes — use it to fill
        inputs before submission, :meth:`result` to read outputs)."""
        return self.hete.data

    # -- future surface ------------------------------------------------------
    def done(self) -> bool:
        """True when the buffer's last submitted writer completed or
        failed (trivially True for never-written buffers)."""
        target = self.session._last_writer(self.hete)
        return target is None or self.session._stream.done(target)

    def exception(self) -> Optional[BaseException]:
        """The failure of the buffer's last submitted writer, if any
        (non-blocking; None while pending or on success)."""
        target = self.session._last_writer(self.hete)
        if target is None:
            return None
        return self.session._stream.exception(target)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Synchronize the buffer: wait for its last submitted writer,
        re-raise its failure if it (or a transitive dependency) failed,
        else ``hete_Sync`` and return the host array."""
        self.session._wait_node(self.session._last_writer(self.hete), timeout)
        return self.session.context.sync(self.hete)

    def free(self) -> bool:
        """``hete_free`` after the stream's last use (see
        :meth:`Session.free`)."""
        return self.session.free(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "done" if self.done() else "pending"
        return (f"BufferFuture(shape={self.hete.shape}, "
                f"dtype={np.dtype(self.hete.dtype).name}, v{self.version}, "
                f"{state})")


class SessionClient:
    """A named tenant handle over a :class:`Session`.

    Carries the client's QoS state (weight, in-flight window, optional
    per-arena quota) and attributes every ``malloc``/``submit`` made
    through it.  Obtained from :meth:`Session.client`; threads that
    submit directly on the session get an implicit per-thread client
    with default QoS settings.
    """

    __slots__ = ("session", "state")

    def __init__(self, session: "Session", state) -> None:
        self.session = session
        self.state = state

    @property
    def name(self) -> str:
        return self.state.name

    def malloc(self, shape, dtype=np.uint8) -> BufferFuture:
        """:meth:`Session.malloc` with the allocation charged to this
        tenant's arena quota."""
        return self.session.malloc(shape, dtype, client=self)

    def submit(self, op_name: str, inputs=(), *, nowait: bool = False,
               **kwargs) -> Union[BufferFuture, Tuple[BufferFuture, ...]]:
        """:meth:`Session.submit` under this client's backpressure
        window and DRR weight.  ``nowait=True`` raises
        :class:`~repro_torch.core.qos.BackpressureFull` instead of blocking
        when the window is full."""
        return self.session.submit(op_name, inputs, client=self,
                                   nowait=nowait, **kwargs)

    def free(self, buf) -> bool:
        return self.session.free(buf)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SessionClient({self.name!r}, weight={self.state.weight}, "
                f"window={self.state.window})")


class Session:
    """Deferred-execution session — the primary RIMMS entry point.

    ``Session(runtime)`` adopts an existing
    :class:`~repro_torch.core.runtime.Runtime` (the dispatch engine);
    :meth:`Session.emulated` builds runtime + context over the emulated
    SoC in one call.  On creation the session installs ``registry``
    (default: :data:`default_registry`) into the runtime — kernels the
    runtime already has win — and starts a
    :class:`~repro_torch.core.executor.StreamExecutor` on the runtime's
    persistent worker pool.

    Submission model: :meth:`submit` builds a task over
    :class:`BufferFuture`/:class:`~repro_torch.core.hete.HeteData` operands,
    extends the live DAG, and admits it to the stream — returning output
    futures immediately.  Sync points are ``future.result()``,
    :meth:`barrier`, and ``with session:`` exit; nothing else blocks.
    Any thread may submit; admission is serialized internally.
    """

    def __init__(
        self,
        runtime: Runtime,
        *,
        scheduler: Optional[str] = None,
        prefetch: bool = True,
        window: int = 64,
        registry: Optional[OpRegistry] = None,
        qos: Optional[QoSManager] = None,
        client_window: int = 64,
        global_window: Optional[int] = None,
        trace: Union[bool, TraceCollector, None] = None,
        backend: Optional[str] = None,
        sampler_period: Optional[float] = None,
        calibration: Union[None, str, CalibrationTable] = None,
    ) -> None:
        self.runtime = runtime
        # Execution backend: None adopts the runtime's;
        # "thread" | "auto" re-resolves it ("process" is not ported and
        # raises; unknown names raise listing the valid choices).
        self.backend = runtime.set_backend(backend)
        self.context: HeteContext = runtime.context
        # Measured calibration: a table — or a path to one,
        # or "auto" ($RIMMS_CALIBRATION) — attached at construction so
        # HEFT placement prices work from measured throughput and
        # _run_kernel dispatches tuned variants.  An embedded divergence
        # snapshot seeds the runtime's live EMAs.
        self.calibration = resolve_calibration(calibration)
        if self.calibration is not None:
            runtime.set_calibration(self.calibration)
            if self.calibration.divergence:
                runtime.divergence.merge(self.calibration.divergence)
        # Full-lifecycle tracing: off by default.  ``trace=True``
        # attaches a fresh TraceCollector to the context; pass an existing
        # collector to aggregate several sessions into one trace.
        if trace:
            tc = trace if isinstance(trace, TraceCollector) else TraceCollector()
            self.context.set_tracer(tc)
        self._trace_pushed = False
        #: session-lifetime metrics (counters/gauges); qos_report adds
        #: per-client latency histograms derived from the fair replay
        self.metrics = MetricsRegistry()
        reg = registry if registry is not None else default_registry
        reg.install(runtime, missing_only=True,
                    extend_supports=("cpu", "gpu"))
        self.registry = reg
        self.closed = False
        # Multi-tenant QoS: per-client backpressure windows +
        # weighted DRR admission.  ``client_window`` is the default
        # in-flight bound per client; ``global_window`` optionally caps
        # the whole admitted frontier.
        self.qos = qos if qos is not None else QoSManager(
            default_window=client_window, global_window=global_window)
        self._builder = GraphBuilder()
        self._events: Dict[int, threading.Event] = {}
        self._node_exc: Dict[int, BaseException] = {}
        self._uses: Dict[int, List[HeteData]] = {}  # node -> retained roots
        self._node_client: Dict[int, Any] = {}  # node -> ClientState
        self._tls = threading.local()  # .client: implicit per-thread client
        self._seq = itertools.count()
        self._client_seq = itertools.count()
        self._stream = StreamExecutor(
            runtime, scheduler=scheduler, prefetch=prefetch,
            on_done=self._node_done, window=window,
        )
        # Submissions mutate the builder's node linkage (deps/dependents)
        # that stream completion iterates: one reentrant lock serializes
        # both (admit() re-enters it).
        self._sublock = self._stream.state_lock
        # Background telemetry sampler: off by default;
        # ``sampler_period=0.0`` builds a manual-tick sampler without a
        # thread, > 0 starts the periodic background thread.
        self.sampler: Optional[Sampler] = None
        if sampler_period is not None:
            self.start_sampler(period=sampler_period)

    @classmethod
    def emulated(
        cls,
        platform: Optional[str] = None,
        *,
        policy: str = "rimms",
        scheduler: str = "heft",
        n_cpu: int = 1,
        accelerators: Sequence[str] = ("gpu0",),
        prefetch: bool = True,
        window: int = 64,
        registry: Optional[OpRegistry] = None,
        qos: Optional[QoSManager] = None,
        client_window: int = 64,
        global_window: Optional[int] = None,
        trace: Union[bool, TraceCollector, None] = None,
        backend: Optional[str] = None,
        sampler_period: Optional[float] = None,
        calibration: Union[None, str, CalibrationTable] = None,
        device=None,
        **soc_kwargs: Any,
    ) -> "Session":
        """Session over a fresh emulated SoC (see
        :func:`~repro_torch.core.runtime.make_emulated_soc` for
        ``soc_kwargs``: ``arena_bytes``, ``topology``, ``acc_ops``, …).
        The default scheduler is the windowed ``heft`` — the streaming
        placement the session exists for; pass ``"round_robin"`` for
        bit-identical-to-serial static placement.

        ``platform`` names a preset from the shorthand registry
        (:func:`~repro_torch.core.runtime.register_platform`; built-ins listed
        by :func:`~repro_torch.core.runtime.platform_names`):
        ``Session.emulated("nvlink_mesh")`` applies the preset's routed
        topology and default arena capacity, with explicit keywords
        still winning.  ``backend`` selects kernel execution — only
        ``"thread"`` (or ``"auto"``, which resolves to it) is ported.
        ``device`` is where accelerator spaces live: ``None`` is CUDA
        (raising when there is none), ``"cpu"`` runs on CPU tensors."""
        if platform is not None:
            from .runtime import _resolve_platform

            entry = _resolve_platform(platform)
            if entry is None:
                raise ValueError(
                    f"unknown platform {platform!r}: registered presets "
                    f"are {platform_names()}")
            factory, preset_arena = entry
            if factory is not None:
                soc_kwargs.setdefault("topology", platform)
            if preset_arena is not None:
                soc_kwargs.setdefault("arena_bytes", preset_arena)
        pes, ctx = make_emulated_soc(
            n_cpu=n_cpu, accelerators=tuple(accelerators), backend=backend,
            device=device, **soc_kwargs
        )
        rt = Runtime(pes, ctx, policy=policy, scheduler=scheduler,
                     backend=backend)
        return cls(rt, prefetch=prefetch, window=window, registry=registry,
                   qos=qos, client_window=client_window,
                   global_window=global_window, trace=trace,
                   sampler_period=sampler_period, calibration=calibration)

    # -- tenants ---------------------------------------------------
    def client(self, name: Optional[str] = None, *,
               weight: Optional[float] = None,
               window: Optional[int] = None,
               quota_bytes: Optional[int] = None,
               think_s: Optional[float] = None,
               slo_latency_s: Optional[float] = None,
               slo_target: Optional[float] = None) -> SessionClient:
        """A named tenant handle: its submissions run under ``weight``
        (DRR admission share), a bounded in-flight ``window``
        (backpressure), and an optional per-device-arena reservation
        ``quota_bytes``.  ``think_s`` declares the client's closed-loop
        think time so the deterministic QoS replay (``qos_report``)
        models its pacing instead of an open-loop burst.
        ``slo_latency_s`` declares a latency objective: tasks
        finishing later than it in the deterministic replay count as
        violations, ``qos_report()["slo"]`` reports the burn rate
        against ``slo_target`` (default 0.99), and violations emit
        ``slo_violation`` instants into the trace.  Calling again with
        the same name updates the passed settings and returns a handle
        to the same client."""
        if name is None:
            name = f"client{next(self._client_seq)}"
        state = self.qos.client(name, weight=weight, window=window,
                                quota_bytes=quota_bytes, think_s=think_s,
                                slo_latency_s=slo_latency_s,
                                slo_target=slo_target)
        if quota_bytes is not None:
            self.context.set_quota(name, quota_bytes)
        return SessionClient(self, state)

    def _thread_client(self) -> SessionClient:
        """The implicit per-thread client: threads that submit directly
        on the session are tenants too (named after the thread), so
        backpressure and fair admission apply uniformly."""
        cl = getattr(self._tls, "client", None)
        if cl is None or cl.session is not self:
            cl = self.client(threading.current_thread().name)
            self._tls.client = cl
        return cl

    def _resolve_client(self, client) -> SessionClient:
        if client is None:
            return self._thread_client()
        if isinstance(client, SessionClient):
            if client.session is not self:
                raise ValueError("SessionClient belongs to another session")
            return client
        return self.client(str(client))

    # -- allocation ----------------------------------------------------------
    def malloc(self, shape, dtype=np.uint8, *,
               client: Union[None, str, SessionClient] = None) -> BufferFuture:
        """``hete_Malloc`` returning a :class:`BufferFuture` (version 0:
        the fresh host bytes are immediately valid — ``.data`` is
        writable for input filling).  The allocation is charged to
        ``client`` (default: the calling thread's implicit client) for
        per-tenant arena quotas."""
        self._check_open()
        owner = self._resolve_client(client).name
        return BufferFuture(self, self.context.malloc(shape, dtype,
                                                      owner=owner))

    def wrap(self, hd: HeteData) -> BufferFuture:
        """Adopt an existing ``hete_Data`` buffer into the session (for
        incremental ports of Task-list code)."""
        return BufferFuture(self, hd)

    def free(self, buf: Union[BufferFuture, HeteData]) -> bool:
        """``hete_free`` with free-after-last-use semantics: frees the
        root allocation immediately when no submitted-but-incomplete
        task touches it, otherwise defers the free to the completion of
        the last such task.  Returns True when freed immediately."""
        hd = buf.hete if isinstance(buf, BufferFuture) else buf
        return self.context.free_when_unused(hd)

    # -- submission ----------------------------------------------------------
    def submit(
        self,
        op_name: str,
        inputs: Sequence[Union[BufferFuture, HeteData, np.ndarray]] = (),
        *,
        out: Union[None, BufferFuture, HeteData,
                   Sequence[Union[BufferFuture, HeteData]]] = None,
        out_shape: Optional[tuple] = None,
        out_dtype: Optional[Any] = None,
        n_out: int = 1,
        pin: Optional[str] = None,
        name: str = "",
        client: Union[None, str, SessionClient] = None,
        nowait: bool = False,
        **params: Any,
    ) -> Union[BufferFuture, Tuple[BufferFuture, ...]]:
        """Submit one op invocation to the stream; returns the output
        :class:`BufferFuture` (or a tuple when there are several).

        ``inputs`` may mix futures, raw ``hete_Data`` buffers, and numpy
        arrays (arrays are hete_malloc'ed and filled on the spot).
        Outputs default to one fresh buffer shaped like the first input
        (override with ``out_shape``/``out_dtype``/``n_out``, or pass
        existing buffers via ``out=`` to write in place).  ``pin`` names
        a PE for CPU-ACC style placement studies; ``params`` are
        forwarded to the kernel.

        Backpressure: the submission runs under ``client``'s
        QoS (default: the calling thread's implicit client).  When the
        client's in-flight window — or the stream's global window — is
        full, the call *blocks* until a completion frees a slot, with
        freed slots granted across waiting clients by weighted deficit
        round-robin; ``nowait=True`` raises
        :class:`~repro_torch.core.qos.BackpressureFull` instead.

        Never blocks on data: dependencies are resolved from the
        buffers' read/write intervals and the task runs when its
        producers complete.  Scheduling and kernel failures surface
        through the returned futures, not here."""
        self._check_open()
        cl = self._resolve_client(client)
        ins_hd = [self._coerce(x, owner=cl.name) for x in inputs]
        outs_hd, single = self._normalize_outs(
            ins_hd, out, out_shape, out_dtype, n_out, owner=cl.name)
        task = Task(
            op_name, ins_hd, outs_hd, params=dict(params), pin=pin,
            name=name or f"{op_name}#{next(self._seq)}", client=cl.name,
        )
        self.metrics.counter("submits").inc()
        tracer = self.context.tracer
        if tracer is not None:
            tracer.instant("submit", "submit", f"tenant:{cl.name}",
                           {"task": task.name, "op": op_name,
                            "client": cl.name})
            t_adm = tracer.now()
        try:
            stall = self.qos.admit(cl.state, admission_cost(task),
                                   nowait=nowait)
        except BackpressureFull:
            self.metrics.counter("backpressure_rejections").inc()
            if tracer is not None:
                tracer.instant("backpressure_full", "qos",
                               f"tenant:{cl.name}",
                               {"task": task.name, "client": cl.name})
            raise
        if tracer is not None:
            tracer.span("qos_admit", "qos", f"tenant:{cl.name}",
                        t_adm, tracer.now(),
                        {"task": task.name, "client": cl.name,
                         "stall_s": stall})
        if stall > 0.0:
            self.metrics.counter("backpressure_blocks").inc()
            if tracer is not None:
                tracer.instant("backpressure_block", "qos",
                               f"tenant:{cl.name}",
                               {"task": task.name, "client": cl.name,
                                "stall_s": stall})
            self.ledger.record_client_stall(cl.name, stall)
        stream_owns_slot = False
        try:
            with self._sublock:
                # Re-check under the lock: close() marks the stream
                # closed under this same lock, so a submission that
                # slipped past _check_open cannot enqueue onto a drained
                # stream or a dead worker pool.
                if self.closed or self._stream.closed:
                    raise SessionClosedError("session is closed")
                node = self._builder.add(task)
                i = node.index
                self._events[i] = threading.Event()
                roots: List[HeteData] = []
                seen: set = set()
                for hd in ins_hd + outs_hd:
                    r = hd.root
                    if id(r) not in seen:
                        seen.add(id(r))
                        roots.append(r)
                        self.context.retain_use(r)
                self._uses[i] = roots
                self._node_client[i] = cl.state
                futures = tuple(
                    BufferFuture(self, hd,
                                 version=self._builder.version_of(hd), node=i)
                    for hd in outs_hd
                )
                # From here the completion callback owns the QoS slot
                # (it releases at task completion or failure).
                stream_owns_slot = True
                self._stream.admit(node)
        except BaseException:
            if not stream_owns_slot:
                self.qos.release(cl.state)
            raise
        return futures[0] if single else futures

    def _coerce(self, x, owner: Optional[str] = None) -> HeteData:
        if isinstance(x, BufferFuture):
            if x.session is not self:
                raise ValueError("BufferFuture belongs to another session")
            return x.hete
        if isinstance(x, HeteData):
            return x
        arr = np.asarray(x)
        hd = self.context.malloc(arr.shape, arr.dtype, owner=owner)
        hd.copies[HOST][...] = arr
        return hd

    def _normalize_outs(
        self, ins_hd, out, out_shape, out_dtype, n_out,
        owner: Optional[str] = None,
    ) -> Tuple[List[HeteData], bool]:
        if out is not None:
            outs = [out] if isinstance(out, (BufferFuture, HeteData)) else list(out)
            return [self._coerce(o) for o in outs], not isinstance(out, (list, tuple))
        if out_shape is None or out_dtype is None:
            if not ins_hd:
                raise ValueError(
                    "submit() with no inputs needs explicit out_shape "
                    "and out_dtype (nothing to infer the output from)"
                )
            # `is None`, not truthiness: shape () is a valid 0-d scalar
            if out_shape is None:
                out_shape = ins_hd[0].shape
            if out_dtype is None:
                out_dtype = ins_hd[0].dtype
        return (
            [self.context.malloc(out_shape, out_dtype, owner=owner)
             for _ in range(n_out)],
            n_out == 1,
        )

    # -- completion plumbing -------------------------------------------------
    def _node_done(self, index: int, exc: Optional[BaseException]) -> None:
        """StreamExecutor completion callback (under the stream lock):
        resolve the node's futures and release its buffer lifecycles —
        a deferred :meth:`free` fires here when this was the buffer's
        last in-flight use."""
        if exc is not None:
            self._node_exc[index] = exc
        for r in self._uses.pop(index, ()):
            self.context.release_use(r)
        state = self._node_client.pop(index, None)
        if state is not None:
            # Free the client's QoS window slot — this is what unblocks
            # a submitter waiting in backpressure (or admits the next
            # DRR grantee).
            self.qos.release(state)
        ev = self._events.get(index)
        if ev is not None:
            ev.set()

    def _last_writer(self, hd: HeteData) -> Optional[int]:
        with self._sublock:
            return self._builder.last_writer(hd)

    def _wait_node(self, index: Optional[int],
                   timeout: Optional[float] = None) -> None:
        if index is None:
            return
        ev = self._events[index]
        if not ev.wait(timeout):
            raise TimeoutError(f"task #{index} still pending after {timeout}s")
        exc = self._node_exc.get(index)
        if exc is not None:
            self._stream.mark_observed(index)
            raise exc

    # -- sync points ---------------------------------------------------------
    def barrier(self, timeout: Optional[float] = None) -> None:
        """Wait for every submitted task to complete; re-raise the first
        failure not already observed through a future's ``result()``."""
        self._stream.barrier(timeout)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                self.barrier()
        finally:
            self.close()

    def close(self) -> None:
        """Drain the stream and stop accepting submissions (idempotent).
        The runtime and its worker pool stay usable — call
        :meth:`Runtime.close` to release the threads.  On close the
        session also stops the telemetry sampler, and pushes the
        modeled track group (+ divergence table, SLO instants) into the
        tracer."""
        if not self.closed:
            self.closed = True
            self._stream.close()
            if self.sampler is not None:
                self.sampler.stop()
            self._push_trace()

    def _push_trace(self) -> None:
        """Derive the stream's modeled track group into the tracer —
        once (the trace shows one deterministic QoS replay of the
        stream).  No-op without a tracer."""
        tracer = self.context.tracer
        if tracer is None or self._trace_pushed:
            return
        self._trace_pushed = True
        timeline, _, finish, release = self._stream.replay(
            admission=self.qos)
        with self._sublock:
            nodes = list(self._builder.nodes)
        run = tracer.add_timeline(timeline, label="stream")
        tracer.add_edges(
            [(d, n.index) for n in nodes for d in sorted(n.deps)], run)
        tracer.add_tenant_spans(
            [(nodes[i].task.client or DEFAULT_CLIENT, release[i], end,
              nodes[i].name, i)
             for i, end in sorted(finish.items())],
            run,
        )
        tracer.set_divergence(self.runtime.divergence.table())
        # SLO alert instants: one per violating task, at its
        # modeled finish time on the owning tenant's track.
        slo_of = {name: cfg["slo_latency_s"]
                  for name, cfg in self.qos.params()["clients"].items()
                  if cfg.get("slo_latency_s") is not None}
        for i, end in sorted(finish.items()):
            client = nodes[i].task.client or DEFAULT_CLIENT
            objective = slo_of.get(client)
            if objective is None:
                continue
            latency = end - release[i]
            if latency > objective:
                tracer.add_model_instant(
                    "slo_violation", "slo", f"{run}/tenant:{client}", end,
                    args={"task": nodes[i].name, "node": i,
                          "latency_s": latency, "objective_s": objective})

    # -- calibration ----------------------------------------------
    def calibrate(self, **kwargs) -> CalibrationTable:
        """Run the measurement harness over this session's registry and
        runtime (see :func:`repro_torch.core.calibrate.calibrate`), attach the
        resulting table to the runtime (placement and variant dispatch
        use it immediately), and return it.  Extends the session's
        existing table when one is attached."""
        from .calibrate import calibrate as _calibrate

        table = _calibrate(self, table=self.calibration, **kwargs)
        self.calibration = table
        self.runtime.set_calibration(table)
        return table

    def save_calibration(self, path) -> CalibrationTable:
        """Snapshot this session's calibration table — plus the
        runtime's live divergence EMAs — to ``path`` (the one documented
        persistence entry point; the raw divergence-JSON path is
        deprecated).  A session without a table saves one holding just
        the divergence snapshot.  Returns the saved table."""
        table = self.calibration if self.calibration is not None \
            else CalibrationTable()
        table.divergence = self.runtime.divergence.state()
        table.save(path)
        return table

    # -- telemetry -------------------------------------------------
    def start_sampler(self, *, period: float = 0.0,
                      max_samples: int = 4096) -> Sampler:
        """Attach (and start, when ``period > 0``) the background
        telemetry sampler: per-PE occupancy and queue depth, arena
        bytes, pressure counters, link busy fractions, and per-tenant
        window/DRR gauges recorded into :attr:`metrics` on every tick.
        ``period=0`` builds a manual-tick sampler (``sampler.tick()``),
        for deterministic tests.  Idempotent; returns the sampler."""
        if self.sampler is None:
            self.sampler = Sampler(self, period=period,
                                   max_samples=max_samples)
        self.sampler.start()
        return self.sampler

    def metrics_text(self) -> str:
        """This session's metrics in Prometheus text exposition format
        (version 0.0.4) — counters, gauges, and histogram summaries."""
        return metrics_text(self.metrics)

    def serve_metrics(self, *, host: str = "127.0.0.1", port: int = 0):
        """Serve :meth:`metrics_text` over a localhost HTTP endpoint
        (``GET /metrics``).  Returns a :class:`MetricsServer`; call
        ``.close()`` when done.  ``port=0`` picks a free port —
        ``server.url`` has the bound address."""
        return serve_metrics(self.metrics_text, host=host, port=port)

    def export_trace(self, path=None) -> Dict[str, Any]:
        """Export the session's trace as a Perfetto-loadable dict (JSON
        written to ``path`` when given — open it in ui.perfetto.dev).
        Requires the session to have a tracer (``Session(trace=...)``).
        Best called after :meth:`close`; calling earlier synchronizes
        (barrier) and freezes the modeled track group at this point."""
        tracer = self.context.tracer
        if tracer is None:
            raise RuntimeError(
                "session has no tracer — construct with Session(trace=True)"
            )
        if not self.closed:
            self.barrier()
            self._push_trace()
        return tracer.export(path)

    def _check_open(self) -> None:
        if self.closed:
            raise SessionClosedError("session is closed")

    # -- evidence ------------------------------------------------------------
    @property
    def ledger(self):
        """The context's transfer ledger (copy counts, modeled seconds)."""
        return self.context.ledger

    def report(self) -> Dict[str, Any]:
        """Schedule evidence for the stream so far.  ``makespan_model``
        and ``timeline`` come from the deterministic replay
        (:func:`~repro_torch.core.executor.replay_schedule`) — call at a sync
        point (after :meth:`barrier`) for exact, machine-independent
        modeled metrics."""
        return self._stream.report()

    def fairness_report(self, clients: Optional[list] = None) -> Dict[str, Any]:
        """Per-client service/stall/eviction evidence + Jain's index
        over weight-normalized modeled service (see
        :meth:`~repro_torch.core.instrument.TransferLedger.fairness_report`),
        using this session's configured client weights."""
        return self.ledger.fairness_report(weights=self.qos.weights(),
                                           clients=clients)

    def qos_report(self) -> Dict[str, Any]:
        """Deterministic multi-tenant schedule evidence.

        Re-simulates the completed stream through
        :func:`~repro_torch.core.qos.fair_replay`: admission itself (windows +
        weighted DRR) is re-enacted in virtual time, so per-task
        ``release``/``finish`` times — and any latency derived from them
        — depend only on each client's own submission order, never on
        wall-clock thread interleaving.  Key per-task times by
        :attr:`BufferFuture.node`.  Call at a sync point (after
        :meth:`barrier`)."""
        timeline, makespan, finish, release = self._stream.replay(
            admission=self.qos)
        with self._sublock:
            client_of = {
                i: (self._builder.nodes[i].task.client or DEFAULT_CLIENT)
                for i in finish
            }
        # Fresh registry per call: qos_report() may be called repeatedly
        # and the replay is a full re-simulation each time — recording
        # into self.metrics would double-count latencies.
        reg = MetricsRegistry()
        lat_by_client: Dict[str, List[float]] = {}
        for i, end in finish.items():
            latency = end - release[i]
            reg.histogram(f"latency_model_s/{client_of[i]}").record(latency)
            lat_by_client.setdefault(client_of[i], []).append(latency)
        percentiles: Dict[str, Dict[str, float]] = {}
        for name, hist in reg.histograms():
            percentiles[name.split("/", 1)[1]] = {
                "p50": hist.percentile(50),
                "p95": hist.percentile(95),
                "p99": hist.percentile(99),
                "mean": hist.mean,
                "count": hist.count,
            }
        # SLO burn rates: evaluated over the same deterministic
        # replay latencies — burn > 1 means the error budget is being
        # spent faster than the objective allows.
        qos_params = self.qos.params()
        slo: Dict[str, Dict[str, Any]] = {}
        for name, cfg in qos_params["clients"].items():
            if cfg.get("slo_latency_s") is None:
                continue
            slo[name] = slo_eval(lat_by_client.get(name, []),
                                 cfg["slo_latency_s"],
                                 cfg.get("slo_target") or 0.99)
        return {
            "makespan_model": makespan,
            "timeline": timeline,
            "finish_model": finish,
            "release_model": release,
            "qos": qos_params,
            "fairness": self.fairness_report(),
            "latency_percentiles": percentiles,
            "metrics": self.metrics.snapshot(),
            "divergence": self.runtime.divergence.table(),
            "slo": slo,
        }
