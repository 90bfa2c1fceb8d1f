"""Paper Table 2: RC / PD / SAR on GPU-only and 3CPU-1GPU configs,
reference vs RIMMS.  Round-robin scheduling reproduces the paper's
batches-of-four task placement on the 3CPU-1GPU setup.

SAR runs at 1/8 way-count (64-way + 32-way) to keep CI-time sane — the
per-task structure (and therefore the copy-elimination ratios) is
identical; way-count scales both policies equally.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_apps [--device cpu]
"""

from __future__ import annotations

import functools

from .common import emit, run_app

CONFIGS = (
    ("gpu_only", dict(n_cpu=0, accelerators=("gpu0",))),
    ("3cpu_1gpu", dict(n_cpu=3, accelerators=("gpu0",))),
)


def run(repeats: int = 3, device=None) -> None:
    from repro_torch.apps.radar import build_pd, build_rc, build_sar

    apps = (
        ("rc", build_rc, {}),
        ("pd", functools.partial(build_pd, ways=128, n=128), {}),
        ("sar", functools.partial(build_sar, scale=8), {}),
    )
    for app_name, builder, kw in apps:
        for cfg_name, cfg in CONFIGS:
            res = {}
            for policy in ("reference", "rimms"):
                res[policy] = run_app(
                    builder, policy=policy, repeats=repeats,
                    n_cpu=cfg["n_cpu"],  # 0 ⇒ no CPU PE ⇒ GPU-only
                    accelerators=cfg["accelerators"],
                    builder_kwargs=kw, device=device,
                )
            ref, rim = res["reference"], res["rimms"]
            spd = ref["wall_s"] / max(rim["wall_s"], 1e-12)
            emit(
                f"table2_{app_name}_{cfg_name}", rim["wall_s"] * 1e6,
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
