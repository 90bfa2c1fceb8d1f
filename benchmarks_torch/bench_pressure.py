"""Capacity pressure: radar pipeline with a working set 2× arena capacity.

The capacity-pressure acceptance benchmark.  A Pulse-Doppler-style pipeline
(``ways`` parallel FFT/FFT→ZIP→IFFT instances over fragmented parents)
allocates six parent buffers; the device arena is sized at HALF their
total footprint, so the runtime must continuously evict + spill-to-host
to make progress.  The run must complete **bit-identical** to an
unconstrained run — in serial mode and in graph mode (prefetch +
queued-reader protection) — while the ledger reports the spill traffic.

Emits `BENCH_pressure.json` (machine-readable, consumed by the CI
perf-regression gate — see benchmarks/check_regression.py).  The gated
metrics are *modeled* (bandwidth model + static cost priors over exact
byte counts), hence deterministic across machines.

Accelerator spaces live on ``--device`` (default CUDA; ``cpu`` runs on
CPU tensors).

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_pressure [--smoke] [--json PATH]
          [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .common import emit

WAYS = 8
N = 1 << 14


def _build(arena_bytes: int, *, ways: int, n: int, seed: int = 0,
           device=None):
    from repro_torch.apps.radar import _parallel_fzf, register_kernels
    from repro_torch.core.runtime import Runtime, make_emulated_soc

    pes, ctx = make_emulated_soc(
        n_cpu=0, accelerators=("gpu0",), arena_bytes=arena_bytes,
        device=device,
    )
    rt = Runtime(pes, ctx, policy="rimms", scheduler="round_robin")
    register_kernels(rt)
    points, tasks = _parallel_fzf(ctx, ways, n, use_fragment=True, seed=seed)
    return rt, ctx, points, tasks


def _outputs(points, ctx, ways: int) -> np.ndarray:
    from repro_torch.core.hete import hete_sync

    return np.stack([
        hete_sync(points["out"][1][i], context=ctx) for i in range(ways)
    ])


def _run_case(mode: str, arena_bytes: int, *, ways: int, n: int,
              device=None) -> dict:
    rt, ctx, points, tasks = _build(arena_bytes, ways=ways, n=n,
                                    device=device)
    run = rt.run if mode == "serial" else rt.run_graph
    wall = run(tasks)
    snap = ctx.ledger.snapshot()
    out = _outputs(points, ctx, ways)
    rt.close()
    return {
        "wall_s": wall,
        "makespan_model": rt.last_makespan_model,
        "copies": snap["total_copies"],
        "bytes": snap["total_bytes"],
        "evictions": snap["total_evictions"],
        "writeback_bytes": snap["writeback_bytes"],
        "spill_stall_s": snap["spill_stall_s"],
        "spill_stall_model_s": rt.timeline.total_spill_s,
        "prefetch_deferrals": snap["prefetch_deferrals"],
        "_out": out,
    }


def run_pressure(*, ways: int, n: int, json_path: str | None,
                 smoke: bool, device=None) -> dict:
    parent_bytes = ways * n * 8  # complex64 parents
    working_set = 6 * parent_bytes  # a, b, fa, fb, z, out
    arena_bytes = working_set // 2  # the 2×-capacity acceptance point

    roomy = _run_case("serial", 64 << 20, ways=ways, n=n, device=device)
    tight_serial = _run_case("serial", arena_bytes, ways=ways, n=n,
                             device=device)
    tight_graph = _run_case("graph", arena_bytes, ways=ways, n=n,
                            device=device)

    identical_serial = bool(np.array_equal(roomy["_out"], tight_serial["_out"]))
    identical_graph = bool(np.array_equal(roomy["_out"], tight_graph["_out"]))
    rec = {
        "bench": "pressure",
        "params": {
            "ways": ways, "n": n, "working_set_bytes": working_set,
            "arena_bytes": arena_bytes, "pressure_ratio": 2.0,
        },
        "unconstrained": {k: v for k, v in roomy.items() if k != "_out"},
        "constrained_serial": {
            k: v for k, v in tight_serial.items() if k != "_out"
        },
        "constrained_graph": {
            k: v for k, v in tight_graph.items() if k != "_out"
        },
        "bit_identical_serial": identical_serial,
        "bit_identical_graph": identical_graph,
        # Regression-gated metrics: deterministic (modeled seconds over
        # exact byte counts; serial victim order is deterministic).
        "gate": {
            "makespan_model": tight_serial["makespan_model"],
            "copies": tight_serial["copies"],
            "evictions": tight_serial["evictions"],
        },
    }

    for name, case in (("unconstrained", roomy),
                       ("constrained_serial", tight_serial),
                       ("constrained_graph", tight_graph)):
        emit(
            f"pressure_{name}", case["wall_s"] * 1e6,
            f"model_ms={case['makespan_model'] * 1e3:.3f};"
            f"copies={case['copies']};evictions={case['evictions']};"
            f"writeback_MiB={case['writeback_bytes'] / 2 ** 20:.2f};"
            f"stall_ms={case['spill_stall_s'] * 1e3:.3f}",
        )

    if smoke:
        assert identical_serial, "serial outputs differ under pressure"
        assert identical_graph, "graph outputs differ under pressure"
        assert tight_serial["evictions"] > 0, "no eviction at 2x capacity?"
        assert tight_graph["evictions"] > 0, "no eviction in graph mode?"
        assert tight_serial["writeback_bytes"] > 0, "no dirty write-back?"
        print("pressure smoke: OK", flush=True)

    if json_path:
        Path(json_path).write_text(json.dumps(rec, indent=1))
        print(f"wrote {json_path}", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small CI run with bit-identity + spill asserts")
    ap.add_argument("--json", default="BENCH_pressure.json",
                    help="machine-readable output path ('' to skip)")
    ap.add_argument("--ways", type=int, default=None)
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
    ways = args.ways or (4 if args.smoke else WAYS)
    n = args.n or (1 << 12 if args.smoke else N)
    print("name,us_per_call,derived")
    from .common import tracing

    with tracing(args.trace_dir, "pressure", metrics_dir=args.metrics_dir):
        run_pressure(ways=ways, n=n, json_path=args.json or None,
                     smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
