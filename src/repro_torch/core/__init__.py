"""RIMMS core on PyTorch: allocators, hete_Data tracking, task runtime."""

from .allocator import AllocError, BitsetAllocator, Extent, NextFitAllocator, make_allocator
from .api import (
    BufferFuture, OpRegistry, Session, SessionClient, SessionClosedError,
    default_registry, op,
)
from .executor import GraphExecutor, StreamExecutor, WorkerPool, replay_schedule
from .graph import CostModel, GraphBuilder, TaskGraph, TaskNode, build_graph
from .hete import (
    HeteContext, HeteData, PrefetchDeferred, default_context,
    hete_free, hete_malloc, hete_sync, tensor_egress, tensor_ingest,
)
from .instrument import (
    Timeline, TimelineEvent, TransferEvent, TransferLedger, Timer,
    jain_index, ledger,
)
from .locations import HOST, BandwidthModel, Location
from .qos import (
    BackpressureFull, ClientState, QoSManager, QuotaExceeded,
    admission_cost, fair_replay,
)
from .pworker import ProcessWorker, ProcessWorkerPool, WorkerDied
from .runtime import (
    BACKENDS, PE, Runtime, Task, make_emulated_soc, platform_names,
    register_platform, resolve_backend, resolve_device, sync_cuda,
)
from .shm import SharedHostArena, describe_array, resolve_handle
from .topology import (
    Link, Topology, TopologyBandwidthModel, TopologyError, build_preset,
)
from .trace import (
    Counter, Gauge, Histogram, MetricsRegistry, TraceCollector,
    global_collector, install_global, trace, trace_lint,
)

__all__ = [
    "AllocError", "BitsetAllocator", "Extent", "NextFitAllocator", "make_allocator",
    "BufferFuture", "OpRegistry", "Session", "SessionClient",
    "SessionClosedError", "default_registry", "op",
    "BackpressureFull", "ClientState", "QoSManager", "QuotaExceeded",
    "admission_cost", "fair_replay", "jain_index",
    "GraphExecutor", "StreamExecutor", "WorkerPool", "replay_schedule",
    "CostModel", "GraphBuilder", "TaskGraph", "TaskNode", "build_graph",
    "HeteContext", "HeteData", "PrefetchDeferred", "default_context",
    "hete_free", "hete_malloc", "hete_sync", "tensor_egress", "tensor_ingest",
    "Timeline", "TimelineEvent", "TransferEvent", "TransferLedger", "Timer",
    "ledger",
    "HOST", "BandwidthModel", "Location",
    "Link", "Topology", "TopologyBandwidthModel", "TopologyError",
    "build_preset",
    "ProcessWorker", "ProcessWorkerPool", "WorkerDied",
    "PE", "Runtime", "Task", "make_emulated_soc", "resolve_device",
    "sync_cuda", "BACKENDS", "resolve_backend", "register_platform",
    "platform_names",
    "SharedHostArena", "describe_array", "resolve_handle",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "TraceCollector",
    "global_collector", "install_global", "trace", "trace_lint",
]
