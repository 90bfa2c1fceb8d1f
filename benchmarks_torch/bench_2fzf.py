"""Paper Table 1: 2FZF execution time, CPU-only vs ACC-only, sizes
32..2048, reference vs RIMMS.

Checks: (1) CPU-only parity — RIMMS adds no overhead when no
accelerator is used (paper: "confirms that the RIMMS protocols ... do
not introduce any overhead"); (2) ACC-only speedup from eliminated
copies.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_2fzf [--device cpu]
"""

from __future__ import annotations

from .common import emit, run_app

SIZES = (32, 64, 128, 256, 512, 1024, 2048)


def run(repeats: int = 5, device=None) -> None:
    from repro_torch.apps.radar import build_2fzf

    for n in SIZES:
        for exec_type, pins in (
            ("cpu_only", ("cpu0",) * 4),
            ("acc_only", ("gpu0",) * 4),
        ):
            res = {}
            for policy in ("reference", "rimms"):
                res[policy] = run_app(
                    lambda ctx, n=n: build_2fzf(ctx, n, pins=pins),
                    policy=policy, repeats=repeats, device=device,
                )
            ref, rim = res["reference"], res["rimms"]
            spd = ref["wall_s"] / max(rim["wall_s"], 1e-12)
            emit(
                f"table1_2fzf_{exec_type}_n{n}",
                rim["wall_s"] * 1e6,
                f"ref_us={ref['wall_s']*1e6:.1f};spdup={spd:.2f}x;"
                f"copies {ref['copies']:.0f}->{rim['copies']:.0f};"
                f"modeled_spdup={ref['modeled_s']/max(rim['modeled_s'],1e-12):.2f}x",
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
