"""Benchmark harness entry point of the port — one module per paper
table/figure (``benchmarks/run.py``'s).

Prints ``name,us_per_call,derived`` CSV rows (benchmarks_torch/common.emit).

``--json-dir DIR`` additionally emits ``BENCH_*.json`` records (full
depth) for the json-capable benches, comparable with
``benchmarks_torch/check_regression.py --baselines
benchmarks/baselines/nightly``.  ``--device`` is where accelerator
spaces live (default CUDA; ``cpu`` runs on CPU tensors).

``overhead``, ``roofline`` and ``multitenant`` are not ported yet: naming
one in ``--only`` raises, and a run of everything skips them.

Run:  PYTHONPATH=src python -m benchmarks_torch.run [--only 2fft,graph] [--device cpu]
"""

import argparse
from pathlib import Path

#: benches of ``benchmarks/run.py`` that the port lacks, and the ROADMAP
#: item that ports each
NOT_PORTED = {"overhead": "A6", "roofline": "A11", "multitenant": "A6"}


def _not_ported(name: str):
    def fail(jp):
        raise NotImplementedError(
            f"bench {name!r} is not ported (ROADMAP {NOT_PORTED[name]})")
    return fail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma list: 2fft,2fzf,alloc,3zip,apps,marking,"
                         "graph,pressure,topology,stream,serve,calibrate "
                         "(overhead, roofline and multitenant are not "
                         "ported)")
    ap.add_argument("--json-dir", default=None, metavar="DIR",
                    help="write BENCH_*.json records for json-capable "
                         "benches into DIR")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="export + lint a Perfetto TRACE_*.json per "
                         "benchmark into DIR")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="write METRICS_*.json (wall/modeled divergence "
                         "tables) per benchmark into DIR (requires "
                         "--trace-dir)")
    ap.add_argument("--device", default=None,
                    help="where accelerator spaces live (default: CUDA; "
                         "'cpu' runs on CPU tensors)")
    args = ap.parse_args(argv)
    from . import (bench_2fft, bench_2fzf, bench_3zip, bench_alloc,
                   bench_apps, bench_calibrate, bench_graph, bench_marking,
                   bench_pressure, bench_serve, bench_stream,
                   bench_topology)

    dev = args.device

    def graph(jp):
        bench_graph.run(device=dev)
        if jp:  # the graph record is the (deterministic) smoke gate's
            bench_graph.smoke(json_path=jp, device=dev)

    benches = {
        "alloc": lambda jp: bench_alloc.run(),
        "overhead": _not_ported("overhead"),
        "2fft": lambda jp: bench_2fft.run(device=dev),
        "2fzf": lambda jp: bench_2fzf.run(device=dev),
        "3zip": lambda jp: bench_3zip.run(device=dev),
        "apps": lambda jp: bench_apps.run(device=dev),
        "marking": lambda jp: bench_marking.run(device=dev),
        "roofline": _not_ported("roofline"),
        "graph": graph,
        "pressure": lambda jp: bench_pressure.run_pressure(
            ways=8, n=1 << 14, json_path=jp, smoke=False, device=dev),
        "topology": lambda jp: bench_topology.run_topology(
            ways=bench_topology.WAYS, n=bench_topology.N,
            depth=bench_topology.DEPTH, json_path=jp, smoke=False,
            device=dev),
        "stream": lambda jp: bench_stream.run_stream(
            clients=bench_stream.CLIENTS, chains=bench_stream.CHAINS,
            n=bench_stream.N, json_path=jp, smoke=False, device=dev),
        "multitenant": _not_ported("multitenant"),
        "serve": lambda jp: bench_serve.run_serve(
            n_users=bench_serve.N_USERS,
            reqs_per_user=bench_serve.REQS_PER_USER,
            json_path=jp, smoke=False, device=dev),
        "calibrate": lambda jp: bench_calibrate.run_calibrate(
            json_path=jp, smoke=False, device=dev),
    }
    json_names = {
        "graph": "BENCH_graph.json",
        "pressure": "BENCH_pressure.json",
        "topology": "BENCH_topology.json",
        "stream": "BENCH_stream.json",
        "serve": "BENCH_serve.json",
        "calibrate": "BENCH_calibrate.json",
    }
    only = set(args.only.split(",")) if args.only else None
    json_dir = Path(args.json_dir) if args.json_dir else None
    if json_dir:
        json_dir.mkdir(parents=True, exist_ok=True)
    print("name,us_per_call,derived")
    from .common import tracing

    for name, fn in benches.items():
        if only and name not in only:
            continue
        if not only and name in NOT_PORTED:
            print(f"# --- {name}: not ported (ROADMAP {NOT_PORTED[name]}) "
                  f"---", flush=True)
            continue
        print(f"# --- {name} ---", flush=True)
        jp = (str(json_dir / json_names[name])
              if json_dir and name in json_names else None)
        with tracing(args.trace_dir, name, metrics_dir=args.metrics_dir):
            fn(jp)


if __name__ == "__main__":
    main()
