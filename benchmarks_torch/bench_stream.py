"""Streaming session throughput: N concurrent clients vs batch.

The acceptance benchmark for the session API redesign.  ``CLIENTS``
submitter threads each stream ``CHAINS`` radar 2FZF chains
(fft, fft → zip → ifft) against ONE :class:`repro.core.api.Session`;
every client pins its chains to one accelerator (clients round-robin
over the PEs), blocks only on its own ``BufferFuture.result()`` calls,
and the persistent WorkerPool consumes the interleaved stream with no
global barrier.  Three claims are checked:

* **bit-identical**: the streamed outputs equal, bitwise, a batch
  ``run_graph`` of the same chains on a fresh runtime — and the per-pair
  copy counts match exactly (the rimms policy does the same data
  movement whether tasks arrive as a stream or as a list);
* **throughput**: the stream's deterministic replayed modeled makespan
  (chains spread over all accelerators, transfers overlapping compute)
  beats the serial-batch baseline — modeled throughput ratio ≥ 1 is the
  acceptance floor, ~#accelerators× is the expectation;
* **determinism**: gated metrics are modeled (static pinned placement +
  the (ready-time, index)-ordered replay), so they are exact across
  machines and submission interleavings — per-PE workloads are fixed
  multisets of identical chains regardless of thread timing.

Emits ``BENCH_stream.json`` for the CI perf-regression gate.

With ``--backend process`` the stream case runs on the process backend:
every host-payload PE executes kernels in a subprocess worker against
shared-memory host arenas (with ``--device cpu`` the accelerators too; on
CUDA they keep in-process dispatch).  The record then adds **measured
wall-clock** speedups — ``wall_speedup_vs_serial`` (gated ≥ baseline on
hosts with ≥ 4 cores, skipped below) and ``wall_speedup_vs_thread``
(reported) — plus a bitwise identity check against the thread-backend
stream.  Modeled gates are identical across backends by construction
(static priors + deterministic replay).

Accelerator spaces live on ``--device`` (default CUDA; ``cpu`` runs on
CPU tensors).

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_stream [--smoke] [--json PATH] [--device cpu] [--backend process]
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from pathlib import Path

import numpy as np

from .common import emit

CLIENTS = 8
CHAINS = 8
N = 1 << 14
N_PROCESS = 1 << 15  # compute-dominant sizes for wall-clock comparisons
ACCELERATORS = ("gpu0", "gpu1")

# Wall-clock gates need real cores: on fewer the process backend cannot
# be expected to beat in-process serial, so the gate is marked skipped.
MIN_CORES_FOR_WALL_GATE = 4


def _chain_seed(client: int, chain: int) -> int:
    return 1000 + client * 97 + chain


def _stream_case(*, clients: int, chains: int, n: int, accelerators,
                 scheduler: str = "round_robin", pin: bool = True,
                 backend=None, warm: bool = False, device=None) -> dict:
    """N client threads stream pinned 2FZF chains against one session;
    returns outputs (client-major), ledger snapshot, replayed modeled
    makespan, and wall seconds."""
    from repro_torch.apps.radar import make_session, submit_2fzf

    session = make_session(
        policy="rimms", scheduler=scheduler, n_cpu=0,
        accelerators=accelerators, backend=backend, device=device,
    )
    if warm:
        # One pinned chain per accelerator: spawns process workers and
        # pays first-touch staging — the measured window below is then
        # steady-state.  (Thread-backend default runs stay warmup-free so
        # their modeled record matches the committed BENCH_stream.json
        # baseline exactly.)
        warm_futs = [
            submit_2fzf(session, n, pins=(pe,) * 4, seed=7,
                        tag=f"_warm{i}")["out"]
            for i, pe in enumerate(accelerators)
        ]
        for f in warm_futs:
            f.result(timeout=600)
    outs: dict = {}
    errors: list = []

    def client(c: int) -> None:
        try:
            pe = accelerators[c % len(accelerators)] if pin else None
            mine = []
            for k in range(chains):
                bufs = submit_2fzf(
                    session, n, pins=(pe,) * 4,
                    seed=_chain_seed(c, k), tag=f"_c{c}k{k}",
                )
                mine.append(bufs["out"])
            # block only on this client's own results (out of order is
            # fine — other clients' chains keep streaming meanwhile)
            outs[c] = [f.result(timeout=300) for f in mine]
        except BaseException as e:  # pragma: no cover - surfaced below
            errors.append(e)

    session.ledger.reset()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    session.barrier()
    wall_meas = time.perf_counter() - t0
    rep = session.report()
    snap = session.ledger.snapshot()
    out = np.stack([np.stack(outs[c]) for c in range(clients)])
    session.close()
    divergence = session.runtime.divergence.table()
    session.runtime.close()
    return {
        "divergence": divergence,
        "wall_s": rep["wall_s"],
        # submit→drain window only (excludes session startup + warmup;
        # rep["wall_s"] counts from executor construction)
        "wall_meas_s": wall_meas,
        "makespan_model": rep["makespan_model"],
        "copies": snap["total_copies"],
        "bytes": snap["total_bytes"],
        "by_pair": snap["by_pair"],
        "n_tasks": rep["n_tasks"],
        "_out": out,
    }


def _batch_case(mode: str, *, clients: int, chains: int, n: int,
                accelerators, backend=None, warm: bool = False,
                device=None) -> dict:
    """The same chains as one batch task list (pins mirror the stream's
    per-client pinning) through serial run() or batch run_graph()."""
    from repro_torch.apps.radar import build_2fzf, make_runtime
    from repro_torch.core.hete import hete_sync

    rt, ctx = make_runtime(policy="rimms", scheduler="round_robin",
                           n_cpu=0, accelerators=accelerators,
                           backend=backend, device=device)
    # internal calls → private impls (the run/run_graph deprecation
    # warning is for user code migrating to Session)
    impl = rt._run_impl if mode == "serial" else rt._run_graph_impl
    if warm:
        # first-touch on throwaway buffers, so the measured run below is
        # steady-state wall (its per-buffer copy counts are untouched:
        # the warm chains are separate mallocs)
        warm_tasks = []
        for i, pe in enumerate(accelerators):
            _, wt = build_2fzf(ctx, n, pins=(pe,) * 4, seed=7)
            warm_tasks += wt
        impl(warm_tasks)
    all_bufs, tasks = [], []
    for c in range(clients):
        pe = accelerators[c % len(accelerators)]
        row = []
        for k in range(chains):
            bufs, chain_tasks = build_2fzf(
                ctx, n, pins=(pe,) * 4, seed=_chain_seed(c, k))
            tasks += chain_tasks
            row.append(bufs)
        all_bufs.append(row)
    ctx.ledger.reset()
    wall = impl(tasks)
    out = np.stack([
        np.stack([hete_sync(bufs["out"], context=ctx) for bufs in row])
        for row in all_bufs
    ])
    # snapshot AFTER syncing outputs: the stream's result() syncs land
    # inside its measured window, so count the batch ones symmetrically
    snap = ctx.ledger.snapshot()
    makespan = rt.last_makespan_model
    rt.close()
    return {
        "wall_s": wall,
        "makespan_model": makespan,
        "copies": snap["total_copies"],
        "bytes": snap["total_bytes"],
        "by_pair": snap["by_pair"],
        "_out": out,
    }


def run_stream(*, clients: int, chains: int, n: int, json_path, smoke,
               backend: str = "thread", device=None) -> dict:
    from repro_torch.core.runtime import resolve_backend

    backend = resolve_backend(backend)
    proc = backend == "process"
    accs = ACCELERATORS
    stream = _stream_case(clients=clients, chains=chains, n=n,
                          accelerators=accs, backend=backend, warm=proc,
                          device=device)
    # batch + serial baselines always run in-process (thread backend):
    # serial wall is THE wall-clock reference the process backend must
    # beat, and batch-graph outputs double as the cross-backend
    # bit-identity reference.
    batch = _batch_case("graph", clients=clients, chains=chains, n=n,
                        accelerators=accs, device=device)
    serial = _batch_case("serial", clients=clients, chains=chains, n=n,
                         accelerators=accs, warm=proc, device=device)
    stream_thread = None
    if proc:
        stream_thread = _stream_case(clients=clients, chains=chains, n=n,
                                     accelerators=accs, backend="thread",
                                     warm=True, device=device)

    identical = bool(np.array_equal(stream["_out"], batch["_out"]))
    copies_match = stream["by_pair"] == batch["by_pair"]
    throughput_x = serial["makespan_model"] / max(stream["makespan_model"],
                                                 1e-12)

    emit(
        "stream_session", stream["wall_s"] * 1e6,
        f"model_ms={stream['makespan_model'] * 1e3:.3f};"
        f"clients={clients};chains={chains};copies={stream['copies']};"
        f"throughput_vs_serial={throughput_x:.2f}x",
    )
    emit(
        "stream_batch_graph", batch["wall_s"] * 1e6,
        f"model_ms={batch['makespan_model'] * 1e3:.3f};"
        f"copies={batch['copies']}",
    )
    emit(
        "stream_serial_baseline", serial["wall_s"] * 1e6,
        f"model_ms={serial['makespan_model'] * 1e3:.3f};"
        f"copies={serial['copies']}",
    )

    rec = {
        "bench": "stream",
        "backend": backend,
        "params": {"clients": clients, "chains": chains, "n": n,
                   "accelerators": list(accs)},
        "stream": {k: v for k, v in stream.items()
                   if k not in ("_out", "by_pair", "divergence")},
        # Wall/modeled calibration table from the stream case:
        # one cell per (span kind, op, PE kind, shape bucket).
        "divergence": stream["divergence"],
        "batch_graph": {k: v for k, v in batch.items()
                        if k not in ("_out", "by_pair")},
        "serial": {k: v for k, v in serial.items()
                   if k not in ("_out", "by_pair")},
        "bit_identical": identical,
        "copies_match": bool(copies_match),
        "throughput_vs_serial": throughput_x,
        # Regression-gated metrics: modeled + deterministic (pinned
        # placement; replay orders by (ready time, index); per-PE work
        # is a fixed multiset of identical chains).
        "gate": {
            "makespan_model": stream["makespan_model"],
            "copies": stream["copies"],
        },
    }
    if proc:
        wall_vs_serial = serial["wall_s"] / max(stream["wall_meas_s"], 1e-12)
        wall_vs_thread = (stream_thread["wall_meas_s"]
                          / max(stream["wall_meas_s"], 1e-12))
        identical_thread = bool(np.array_equal(stream["_out"],
                                               stream_thread["_out"]))
        rec["wall_speedup_vs_serial"] = wall_vs_serial
        rec["wall_speedup_vs_thread"] = wall_vs_thread
        rec["bit_identical_vs_thread"] = identical_thread
        # The wall gate is real measured time, gated as higher-is-better
        # (direction "min": FAIL below baseline*(1-tol)) — but only on
        # hosts with enough cores to make the comparison meaningful.
        rec["gate_directions"] = {"wall_speedup_vs_serial": "min"}
        rec["gate_tolerances"] = {"wall_speedup_vs_serial": 0.0}
        if (os.cpu_count() or 1) >= MIN_CORES_FOR_WALL_GATE:
            rec["gate"]["wall_speedup_vs_serial"] = wall_vs_serial
        else:
            rec["gate_skipped"] = ["wall_speedup_vs_serial"]
        emit(
            "stream_process_wall", stream["wall_meas_s"] * 1e6,
            f"vs_serial={wall_vs_serial:.2f}x;vs_thread={wall_vs_thread:.2f}x;"
            f"cores={os.cpu_count()};bit_identical_vs_thread="
            f"{identical_thread}",
        )

    if smoke:
        import math

        compute_ratios = [
            c["ema_ratio"] for c in stream["divergence"].values()
            if c["kind"] == "compute" and c["count"] > 0
        ]
        assert any(r is not None and r > 0 and math.isfinite(r)
                   for r in compute_ratios), (
            f"divergence table has no (op, PE kind) compute cell with a "
            f"finite positive wall/modeled ratio: {stream['divergence']}"
        )
        assert identical, "streamed outputs differ from batch run_graph"
        assert copies_match, (
            f"stream copy counts differ from batch run_graph: "
            f"{stream['by_pair']} vs {batch['by_pair']}"
        )
        assert throughput_x >= 1.0, (
            f"stream modeled throughput only {throughput_x:.2f}x the "
            f"serial-batch baseline (acceptance: >=1x)"
        )
        if proc:
            assert rec["bit_identical_vs_thread"], (
                "process-backend stream outputs differ bitwise from the "
                "thread-backend stream"
            )
            assert stream["by_pair"] == stream_thread["by_pair"], (
                f"process copy counts differ from thread: "
                f"{stream['by_pair']} vs {stream_thread['by_pair']}"
            )
        print(f"stream smoke: OK ({clients} clients, backend={backend}, "
              f"{throughput_x:.2f}x serial throughput, "
              f"copies match batch)", flush=True)

    if json_path:
        Path(json_path).write_text(json.dumps(rec, indent=1))
        print(f"wrote {json_path}", flush=True)
    return rec


def run(clients: int = CLIENTS, chains: int = CHAINS, n: int = N,
        backend: str = "thread", device=None) -> None:
    run_stream(clients=clients, chains=chains, n=n, json_path=None,
               smoke=False, backend=backend, device=device)


def main() -> None:
    from repro_torch.core.runtime import BACKENDS, resolve_backend

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small CI run with bit-identity + copy-count + "
                         "throughput asserts")
    ap.add_argument("--json", default="BENCH_stream.json",
                    help="machine-readable output path ('' to skip)")
    ap.add_argument("--backend", default="thread", choices=BACKENDS,
                    help="kernel-execution backend for the stream case "
                         "(process adds wall-clock speedup metrics vs the "
                         "in-process serial + thread baselines)")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="export + lint a Perfetto trace of the run")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="write a METRICS_*.json divergence table "
                         "(requires --trace-dir)")
    ap.add_argument("--device", default=None,
                    help="where accelerator spaces live (default: CUDA; "
                         "'cpu' runs on CPU tensors)")
    args = ap.parse_args()
    backend = resolve_backend(args.backend)
    clients = args.clients or (4 if args.smoke else CLIENTS)
    chains = args.chains or (6 if args.smoke else CHAINS)
    # process smoke uses compute-dominant sizes: at tiny n the pipe
    # round-trip dominates and wall comparisons measure only overhead
    n = args.n or ((N_PROCESS if backend == "process" else 1 << 13)
                   if args.smoke else N)
    print("name,us_per_call,derived")
    from .common import tracing

    trace_name = "stream" if backend == "thread" else f"stream_{backend}"
    with tracing(args.trace_dir, trace_name, metrics_dir=args.metrics_dir):
        run_stream(clients=clients, chains=chains, n=n,
                   json_path=args.json or None, smoke=args.smoke,
                   backend=backend, device=args.device)


if __name__ == "__main__":
    main()
