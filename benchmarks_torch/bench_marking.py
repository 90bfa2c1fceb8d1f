"""Paper Fig 10 + Table 3: marking-system comparison on the PD app.

Fig 10 — allocation overhead of the PD Computation region's 8 data
points × 128 parallel buffers under (a) bitset (block 4096), (b)
next-fit, (c) next-fit + fragment (1 alloc + O(n) fragment per point).

Table 3 — Overall vs Computation-only speedup convergence with repeat
count: allocation happens once, computation repeats N times; the
allocation scheme's overhead should wash out with repeats (fastest with
NF+fragment).

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_marking [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from .common import emit, run_app

WAYS, N = 128, 128
POINTS = 8  # data points in the PD computation region (Fig 9 edges)


def _alloc_overhead(kind: str, use_fragment: bool, iters: int = 3) -> float:
    from repro_torch.core.hete import HeteContext, MemorySpace
    from repro_torch.core.locations import Location

    ts = []
    for _ in range(iters):
        ctx = HeteContext()
        loc = Location("device", "acc0")
        ctx.register_space(MemorySpace(
            loc, capacity=64 << 20, allocator=kind, block_size=4096,
            ingest=lambda a: a, egress=lambda a: np.asarray(a),
        ))
        t0 = time.perf_counter()
        parents = []
        for _ in range(POINTS):
            if use_fragment:
                hd = ctx.malloc((WAYS * N,), np.complex64, spaces=[loc])
                hd.fragment(N)
                parents.append(hd)
            else:
                parents.extend(
                    ctx.malloc((N,), np.complex64, spaces=[loc])
                    for _ in range(WAYS)
                )
        for hd in parents:
            ctx.free(hd)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def run(repeat_counts=(1, 10, 50), device=None) -> None:
    # ---- Fig 10: allocation overhead per scheme -------------------------
    t_bitset = _alloc_overhead("bitset", use_fragment=False)
    t_nf = _alloc_overhead("nextfit", use_fragment=False)
    t_nf_frag = _alloc_overhead("nextfit", use_fragment=True)
    emit("fig10_alloc_bitset", t_bitset * 1e6, f"{POINTS}x{WAYS} allocs")
    emit("fig10_alloc_nf", t_nf * 1e6,
         f"speedup_vs_bitset={t_bitset/max(t_nf,1e-12):.2f}x (paper: 2.55x)")
    emit("fig10_alloc_nf_fragment", t_nf_frag * 1e6,
         f"speedup_vs_nf={t_nf/max(t_nf_frag,1e-12):.2f}x (paper: 18.53x)")

    # ---- Table 3: overall vs computation-only across repeats -------------
    from repro_torch.apps.radar import build_pd

    comp = {}
    for policy in ("reference", "rimms"):
        comp[policy] = run_app(
            lambda ctx: build_pd(ctx, ways=32, n=128, use_fragment=True),
            policy=policy, repeats=3, n_cpu=0, accelerators=("gpu0",),
            device=device,
        )
    comp_spd = comp["reference"]["wall_s"] / max(comp["rimms"]["wall_s"], 1e-12)
    emit("table3_computation_only", comp["rimms"]["wall_s"] * 1e6,
         f"spdup={comp_spd:.2f}x")
    for reps in repeat_counts:
        for scheme, kind, frag in (("bitset", "bitset", False),
                                   ("nf", "nextfit", False),
                                   ("nf_fragment", "nextfit", True)):
            alloc_s = _alloc_overhead(kind, frag, iters=1)
            total_rimms = alloc_s + reps * comp["rimms"]["wall_s"]
            total_ref = alloc_s + reps * comp["reference"]["wall_s"]
            emit(
                f"table3_overall_{scheme}_r{reps}", total_rimms * 1e6,
                f"spdup={total_ref/max(total_rimms,1e-12):.2f}x;"
                f"comp_only={comp_spd:.2f}x",
            )


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="where accelerator spaces live (default: CUDA; "
                         "'cpu' runs on CPU tensors)")
    args = ap.parse_args()
    run(device=args.device)


if __name__ == "__main__":
    main()
