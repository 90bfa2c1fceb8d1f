"""Shared benchmark helpers of the port (``benchmarks/common.py``'s):
timing, CSV emit, app runners, tracing."""

from __future__ import annotations

import contextlib
import json
import os
import platform
import time
from pathlib import Path
from typing import Callable, Dict, List

ROWS: List[str] = []


@contextlib.contextmanager
def tracing(trace_dir, bench_name: str, *, capacity: int = 1 << 18,
            lint: bool = True, metrics_dir=None):
    """Trace one benchmark run end to end.

    With a falsy ``trace_dir`` this is a no-op (yields ``None``) — the
    benchmark runs exactly as before, tracer-free.  Otherwise a fresh
    process-global :class:`~repro_torch.core.trace.TraceCollector` is
    installed for the block (every ``HeteContext`` the bench creates
    attaches automatically), the trace is exported to
    ``<trace_dir>/TRACE_<bench_name>.json`` (Perfetto-loadable), and
    ``trace_lint`` validates it — a violation fails the benchmark.

    The wall/modeled divergence observed by every runtime the block
    creates is aggregated and embedded in the trace
    (``doc["rimms"]["divergence"]``); with ``metrics_dir``
    set, the table is additionally written to
    ``<metrics_dir>/METRICS_<bench_name>.json``.
    """
    if not trace_dir:
        yield None
        return
    from repro_torch.core import telemetry
    from repro_torch.core.trace import (TraceCollector, global_collector,
                                  install_global, trace_lint)

    prev = global_collector()
    tc = TraceCollector(capacity_per_thread=capacity)
    install_global(tc)
    serial = telemetry.divergence_serial()
    try:
        yield tc
    finally:
        install_global(prev)
    div = telemetry.aggregate_divergence(since=serial).table()
    tc.set_divergence(div)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"TRACE_{bench_name}.json"
    doc = tc.export(str(path))
    meta = doc["rimms"]
    print(f"trace: {path} ({meta['n_wall_events']} wall + "
          f"{meta['n_model_events']} modeled events, "
          f"{len(div)} divergence cells)", flush=True)
    if metrics_dir:
        mdir = Path(metrics_dir)
        mdir.mkdir(parents=True, exist_ok=True)
        mpath = mdir / f"METRICS_{bench_name}.json"
        mpath.write_text(json.dumps(
            {"bench": bench_name, "divergence": div}, indent=1))
        print(f"metrics: {mpath}", flush=True)
    if lint:
        violations = trace_lint(doc)
        if violations:
            msg = "\n".join(f"  - {v}" for v in violations)
            raise AssertionError(
                f"trace_lint failed for {path}:\n{msg}")


def host_cpu() -> str:
    """The host CPU's model, architecture and logical CPU count: host-timed
    numbers belong to it.  The model is ``/proc/cpuinfo``'s model name,
    or its vendor, family and model numbers where the name reads
    "unknown" (as on some virtualised hosts)."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block is enough
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    model = info.get("model name", "unknown")
    if model == "unknown" and "vendor_id" in info:
        model = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                 f"model {info.get('model', '?')}")
    return (f"{model} ({platform.machine()}, {os.cpu_count()} logical "
            f"CPUs)")


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    row = f"{name},{us_per_call:.3f},{derived}"
    ROWS.append(row)
    print(row, flush=True)


def time_it(fn: Callable, *, repeats: int = 5, warmup: int = 1) -> float:
    """Median wall seconds of fn() over repeats."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def run_app(builder, *, policy: str, accelerators=("gpu0",), n_cpu: int = 1,
            scheduler: str = "round_robin", repeats: int = 5,
            allocator: str = "nextfit", backend=None,
            builder_kwargs=None, device=None) -> Dict:
    """Build + run one radar app; returns measured/modeled time + ledger.
    ``backend`` selects kernel execution (see
    :func:`repro_torch.core.runtime.resolve_backend`); ``device`` is
    where accelerator spaces live (``None``: CUDA, ``"cpu"``: CPU
    tensors).  The first run is a warm-up (on the card it also builds
    the kernels, and the runtime waits for every kernel it launches);
    the serial dispatch goes through the private impl so the Runtime.run
    deprecation warning stays pointed at user code."""
    from repro_torch.apps.radar import make_runtime

    rt, ctx = make_runtime(policy=policy, scheduler=scheduler, n_cpu=n_cpu,
                           accelerators=accelerators, allocator=allocator,
                           backend=backend, device=device)
    bufs, tasks = builder(ctx, **(builder_kwargs or {}))
    rt._run_impl(tasks)  # warmup
    ctx.ledger.reset()
    t0 = time.perf_counter()
    for _ in range(repeats):
        rt._run_impl(tasks)
    wall = (time.perf_counter() - t0) / repeats
    snap = ctx.ledger.snapshot()
    rt.close()
    return {
        "wall_s": wall,
        "copies": snap["total_copies"] / repeats,
        "bytes": snap["total_bytes"] / repeats,
        "modeled_s": snap["modeled_seconds"] / repeats,
        # per-(src,dst) transfer matrix (per *link* under a topology):
        # copies/bytes/modeled_s per directed pair
        "per_link": snap["per_link"],
        "ledger": snap,
    }
