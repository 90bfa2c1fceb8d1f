"""Serial vs async task-graph executor: makespan on fork-join DAGs.

For 1–4 emulated accelerators, runs the same fork-join workload
(shared source → parallel fft/zip branches → pairwise zip reduction)
through serial :meth:`Runtime.run` and the graph executor
:meth:`Runtime.run_graph`, and reports:

* measured wall seconds (honest but pessimistic on this box — every
  emulated PE shares one physical CPU, so threading adds overhead
  without adding FLOPs),
* **modeled makespan** — the schedule simulation under the platform
  :class:`BandwidthModel` + static compute estimates, identical cost
  basis for both modes, so the ratio isolates what the DAG scheduler
  buys: transfer/compute overlap and multi-PE concurrency,
* ledger copy counts (must match between modes under ``rimms`` with
  static scheduling — asserted in ``--smoke``).

Accelerator spaces live on ``--device`` (default CUDA; ``cpu`` runs on
CPU tensors).  Only the thread backend is ported (``--backend process``
raises, ``auto`` resolves to thread), so the process record
(``BENCH_graph_process.json``) has no counterpart here.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_graph [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .common import emit

WAYS = 8
N = 1 << 15
DEPTH = 2


def _build(scheduler: str, accelerators, *, policy: str = "rimms",
           ways: int = WAYS, n: int = N, depth: int = DEPTH,
           backend=None, device=None):
    from repro_torch.apps.radar import make_runtime
    from repro_torch.apps.synthetic import build_fork_join

    rt, ctx = make_runtime(policy=policy, n_cpu=0,
                           accelerators=accelerators, scheduler=scheduler,
                           backend=backend, device=device)
    bufs, tasks = build_fork_join(ctx, ways=ways, n=n, depth=depth)
    return rt, ctx, bufs, tasks


def _measure(rt, ctx, tasks, mode: str, repeats: int):
    # internal calls → private impls (run/run_graph deprecation warnings
    # are for user code migrating to Session)
    run = rt._run_impl if mode == "serial" else rt._run_graph_impl
    run(tasks)  # warmup: first-touch transfers (the kernels are built)
    ctx.ledger.reset()
    wall = model = float("inf")
    for _ in range(repeats):
        wall = min(wall, run(tasks))
        model = min(model, rt.last_makespan_model)
    copies = ctx.ledger.total_copies / repeats
    return wall, model, copies


def run(repeats: int = 3, ways: int = WAYS, n: int = N, depth: int = DEPTH,
        device=None) -> None:
    for n_acc in (1, 2, 3, 4):
        accs = tuple(f"gpu{i}" for i in range(n_acc))
        results = {}
        for mode, sched in (("serial", "round_robin"),
                            ("graph", "round_robin"),
                            ("graph", "heft")):
            rt, ctx, _, tasks = _build(sched, accs, ways=ways, n=n,
                                       depth=depth, device=device)
            results[(mode, sched)] = _measure(rt, ctx, tasks, mode, repeats)
        sw, sm, sc = results[("serial", "round_robin")]
        for mode, sched in (("graph", "round_robin"), ("graph", "heft")):
            gw, gm, gc = results[(mode, sched)]
            emit(
                f"graph_forkjoin_acc{n_acc}_{sched}", gw * 1e6,
                f"serial_wall_us={sw * 1e6:.1f};model_ms={gm * 1e3:.3f};"
                f"serial_model_ms={sm * 1e3:.3f};"
                f"model_speedup={sm / max(gm, 1e-12):.2f}x;"
                f"copies {sc:.0f}->{gc:.0f}",
            )


def smoke(json_path: str | None = None, backend: str = "thread",
          device=None) -> None:
    """CI gate: graph mode must (1) match serial outputs bitwise and
    copy-counts exactly under rimms/round_robin, and (2) beat the serial
    modeled makespan on a 2-accelerator fork-join workload."""
    import json
    from pathlib import Path

    from repro_torch.core.hete import hete_sync
    from repro_torch.core.runtime import resolve_backend

    backend = resolve_backend(backend)
    accs = ("gpu0", "gpu1")
    ways, n, depth, repeats = 4, 1 << 13, 2, 2

    rt_s, ctx_s, bufs_s, tasks_s = _build("round_robin", accs,
                                          ways=ways, n=n, depth=depth,
                                          device=device)
    rt_g, ctx_g, bufs_g, tasks_g = _build("round_robin", accs,
                                          ways=ways, n=n, depth=depth,
                                          backend=backend, device=device)
    sw, sm, sc = _measure(rt_s, ctx_s, tasks_s, "serial", repeats)
    gw, gm, gc = _measure(rt_g, ctx_g, tasks_g, "graph", repeats)

    out_s = hete_sync(bufs_s["out"], context=ctx_s)
    out_g = hete_sync(bufs_g["out"], context=ctx_g)
    assert np.array_equal(out_s, out_g), "graph outputs differ from serial"
    assert ctx_s.ledger.snapshot()["by_pair"] == ctx_g.ledger.snapshot()["by_pair"], (
        "graph copy counts differ from serial under rimms/round_robin"
    )
    assert gm < sm, (
        f"graph modeled makespan {gm * 1e3:.3f} ms not below serial "
        f"{sm * 1e3:.3f} ms on a 2-accelerator fork-join"
    )
    rt_g.close()
    rt_s.close()
    emit("graph_smoke", gw * 1e6,
         f"backend={backend};model_speedup={sm / gm:.2f}x;"
         f"copies={gc:.0f};OK")
    if json_path:
        # Gated metrics are modeled (deterministic across machines):
        # static placement → exact copy counts and makespan arithmetic.
        rec = {
            "bench": "graph",
            "backend": backend,
            "params": {"ways": ways, "n": n, "depth": depth,
                       "accelerators": list(accs)},
            "serial": {"makespan_model": sm, "copies": sc, "wall_s": sw},
            "graph": {"makespan_model": gm, "copies": gc, "wall_s": gw},
            "model_speedup": sm / gm,
            "gate": {"makespan_model": gm, "copies": gc},
        }
        Path(json_path).write_text(json.dumps(rec, indent=1))
        print(f"wrote {json_path}", flush=True)
    print(f"graph smoke: OK (backend={backend})", flush=True)


def main() -> None:
    from repro_torch.core.runtime import BACKENDS, resolve_backend

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small CI run with equivalence + speedup asserts")
    ap.add_argument("--json", default="BENCH_graph.json",
                    help="machine-readable smoke output path ('' to skip)")
    ap.add_argument("--backend", default="thread", choices=BACKENDS,
                    help="kernel-execution backend for the graph case "
                         "(only thread is ported)")
    ap.add_argument("--device", default=None,
                    help="where accelerator spaces live (default: CUDA; "
                         "'cpu' runs on CPU tensors)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="export + lint a Perfetto trace of the run")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="write a METRICS_*.json divergence table "
                         "(requires --trace-dir)")
    args = ap.parse_args()
    backend = resolve_backend(args.backend)
    print("name,us_per_call,derived")
    from .common import tracing

    trace_name = "graph" if backend == "thread" else f"graph_{backend}"
    with tracing(args.trace_dir, trace_name, metrics_dir=args.metrics_dir):
        if args.smoke:
            smoke(args.json or None, backend=backend, device=args.device)
        else:
            run(device=args.device)


if __name__ == "__main__":
    main()
