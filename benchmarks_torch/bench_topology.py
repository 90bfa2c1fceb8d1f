"""Interconnect topology: peer-mesh vs host-bridged platforms.

The same radar fork-join task graph (shared FFT source → parallel
fft/zip branches → pairwise zip joins, all radar ops) runs on two
modeled platforms built from the same PEs:

* ``nvlink_mesh``     — fast direct peer links between the accelerators;
* ``host_bridged_fpga`` — no peer links at all: every device↔device
  transfer routes through the host over slow UDMA links, which also
  serialize under contention.

Outputs must be **bit-identical** (the topology changes modeled cost and
routing accounting, never data), while the peer mesh must beat the
host-bridged platform by ≥1.3× modeled makespan — the join reductions'
device↔device traffic sits on the critical path, so routing quality is
exactly what the gap measures.

A second scenario demonstrates **spill-to-peer**: a pulse-Doppler
working set 2× one accelerator's arena, every task pinned to that
accelerator, with an idle roomy peer one fast link away.  Eviction
write-back chooses the peer over the host (cheaper link), the ledger's
``spills_to_peer`` counter proves it, and outputs stay bit-identical to
an unconstrained run.

All gated metrics are *modeled* (deterministic: static round-robin
placement + the executor's deterministic topology replay).

Accelerator spaces live on ``--device`` (default CUDA; ``cpu`` runs on
CPU tensors); on one card both accelerators' spaces are ``cuda:0``, each
with its own arena, and the topology is modeled, as in the reference.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_topology [--smoke] [--json PATH]
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
DEPTH = 2
MESH = "nvlink_mesh"
BRIDGED = "host_bridged_fpga"


def _soc(topology, *, arena_bytes=64 << 20, accelerators=("gpu0", "gpu1"),
         device=None):
    from repro_torch.apps.radar import register_kernels
    from repro_torch.core.runtime import Runtime, make_emulated_soc

    pes, ctx = make_emulated_soc(
        n_cpu=0, accelerators=accelerators, arena_bytes=arena_bytes,
        topology=topology, device=device,
    )
    rt = Runtime(pes, ctx, policy="rimms", scheduler="round_robin")
    register_kernels(rt)
    return rt, ctx


def _run_forkjoin(topology, mode, *, ways, n, depth, device=None):
    from repro_torch.apps.synthetic import build_fork_join
    from repro_torch.core.hete import hete_sync

    rt, ctx = _soc(topology, device=device)
    bufs, tasks = build_fork_join(ctx, ways=ways, n=n, depth=depth, seed=1)
    wall = (rt.run if mode == "serial" else rt.run_graph)(tasks)
    snap = ctx.ledger.snapshot()
    out = hete_sync(bufs["out"], context=ctx)
    rt.close()
    return {
        "wall_s": wall,
        "makespan_model": rt.last_makespan_model,
        "copies": snap["total_copies"],
        "bytes": snap["total_bytes"],
        "per_link": snap["per_link"],
        "_out": out,
    }


def _run_spill(topology, *, ways, n, constrained: bool, device=None):
    """Pulse-Doppler chain pinned to gpu0; gpu1 is an idle peer arena one
    fast link away.  Constrained: gpu0's arena is half the working set,
    so eviction must spill — to the peer when the link beats host."""
    from repro_torch.apps.radar import _parallel_fzf
    from repro_torch.core.hete import hete_sync

    working_set = 6 * ways * n * 8  # six complex64 parents
    arena = {"gpu0": (working_set // 2 if constrained else 64 << 20),
             "gpu1": 64 << 20}
    rt, ctx = _soc(topology, arena_bytes=arena, device=device)
    points, tasks = _parallel_fzf(ctx, ways, n, use_fragment=True, seed=0)
    for t in tasks:
        t.pin = "gpu0"
    wall = rt._run_impl(tasks)  # serial: deterministic victim order
    snap = ctx.ledger.snapshot()
    out = np.stack([
        hete_sync(points["out"][1][i], context=ctx) for i in range(ways)
    ])
    rt.close()
    return {
        "wall_s": wall,
        "makespan_model": rt.last_makespan_model,
        "copies": snap["total_copies"],
        "evictions": snap["total_evictions"],
        "spills_to_peer": snap["spills_to_peer"],
        "peer_writeback_MiB": snap["peer_writeback_bytes"] / 2 ** 20,
        "writeback_bytes": snap["writeback_bytes"],
        "_out": out,
    }


def run_topology(*, ways, n, depth, json_path, smoke, device=None) -> dict:
    cases = {}
    for topo in (MESH, BRIDGED):
        for mode in ("serial", "graph"):
            cases[(topo, mode)] = _run_forkjoin(
                topo, mode, ways=ways, n=n, depth=depth, device=device)

    mesh_g, bridged_g = cases[(MESH, "graph")], cases[(BRIDGED, "graph")]
    speedup = bridged_g["makespan_model"] / mesh_g["makespan_model"]
    identical = all(
        np.array_equal(mesh_g["_out"], c["_out"]) for c in cases.values()
    )

    spill = _run_spill(MESH, ways=ways, n=n, constrained=True, device=device)
    roomy = _run_spill(MESH, ways=ways, n=n, constrained=False,
                       device=device)
    spill_identical = bool(np.array_equal(spill["_out"], roomy["_out"]))

    for (topo, mode), c in cases.items():
        emit(
            f"topology_{topo}_{mode}", c["wall_s"] * 1e6,
            f"model_ms={c['makespan_model'] * 1e3:.3f};"
            f"copies={c['copies']};bytes_MiB={c['bytes'] / 2 ** 20:.2f}",
        )
    emit(
        "topology_spill_to_peer", spill["wall_s"] * 1e6,
        f"model_ms={spill['makespan_model'] * 1e3:.3f};"
        f"evictions={spill['evictions']};"
        f"spills_to_peer={spill['spills_to_peer']};"
        f"peer_writeback_MiB={spill['peer_writeback_MiB']:.2f}",
    )
    busiest = sorted(
        bridged_g["per_link"].items(),
        key=lambda kv: -kv[1]["modeled_s"],
    )[:4]
    for link, row in busiest:
        emit(
            f"topology_link[{link}]", row["modeled_s"] * 1e6,
            f"copies={row['copies']};bytes_MiB={row['bytes'] / 2 ** 20:.2f}",
        )

    rec = {
        "bench": "topology",
        "params": {"ways": ways, "n": n, "depth": depth,
                   "mesh": MESH, "bridged": BRIDGED},
        "mesh_graph": {k: v for k, v in mesh_g.items()
                       if k not in ("_out", "per_link")},
        "bridged_graph": {k: v for k, v in bridged_g.items()
                          if k not in ("_out", "per_link")},
        "mesh_serial": {k: v for k, v in cases[(MESH, "serial")].items()
                        if k not in ("_out", "per_link")},
        "bridged_serial": {
            k: v for k, v in cases[(BRIDGED, "serial")].items()
            if k not in ("_out", "per_link")
        },
        "model_speedup_mesh_over_bridged": speedup,
        "bit_identical": bool(identical),
        "spill_to_peer": {k: v for k, v in spill.items() if k != "_out"},
        "spill_bit_identical": spill_identical,
        # Regression-gated metrics: all modeled + deterministic (static
        # placement, deterministic topology replay, serial spill case).
        "gate": {
            "makespan_model_mesh": mesh_g["makespan_model"],
            "makespan_model_bridged": bridged_g["makespan_model"],
            "mesh_over_bridged": mesh_g["makespan_model"]
            / bridged_g["makespan_model"],
            "copies_mesh": mesh_g["copies"],
            "spill_makespan_model": spill["makespan_model"],
        },
    }

    if smoke:
        assert identical, "outputs differ across topologies/modes"
        assert speedup >= 1.3, (
            f"peer mesh only {speedup:.2f}x over host-bridged "
            f"(acceptance: >=1.3x modeled makespan)"
        )
        assert spill["evictions"] > 0, "no eviction at 2x capacity?"
        assert spill["spills_to_peer"] > 0, (
            "no spill-to-peer despite a cheaper idle peer arena"
        )
        assert spill_identical, "spill-to-peer changed results"
        print(f"topology smoke: OK (mesh {speedup:.2f}x over bridged, "
              f"{spill['spills_to_peer']} spills to peer)", flush=True)

    if json_path:
        Path(json_path).write_text(json.dumps(rec, indent=1))
        print(f"wrote {json_path}", flush=True)
    return rec


def run(ways: int = WAYS, n: int = N, depth: int = DEPTH,
        device=None) -> None:
    run_topology(ways=ways, n=n, depth=depth, json_path=None, smoke=False,
                 device=device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small CI run with bit-identity + speedup + "
                         "spill-to-peer asserts")
    ap.add_argument("--json", default="BENCH_topology.json",
                    help="machine-readable output path ('' to skip)")
    ap.add_argument("--ways", type=int, default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--depth", type=int, default=DEPTH)
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
    n = args.n or (1 << 13 if args.smoke else N)
    print("name,us_per_call,derived")
    from .common import tracing

    with tracing(args.trace_dir, "topology", metrics_dir=args.metrics_dir):
        run_topology(ways=ways, n=n, depth=args.depth,
                     json_path=args.json or None, smoke=args.smoke,
                     device=args.device)


if __name__ == "__main__":
    main()
