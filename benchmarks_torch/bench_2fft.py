"""Paper Fig 5 (ZCU102) / Fig 6 (Jetson): 2FFT reference vs RIMMS.

Scenarios: CPU-ACC (first FFT on CPU, second on accelerator) and
ACC-ACC (both on the same accelerator).  The paper's structural claim —
RIMMS eliminates 1 copy in CPU-ACC and 3 copies in ACC-ACC — is asserted
exactly from the transfer ledger; wall / modeled times are reported per
size 64..2048.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_2fft [--device cpu]
"""

from __future__ import annotations

from .common import emit, run_app

SIZES = (64, 128, 256, 512, 1024, 2048)


def run(repeats: int = 5, device=None) -> None:
    from repro_torch.apps.radar import build_2fft

    for scen, pins in (("cpu_acc", ("cpu0", "gpu0")),
                       ("acc_acc", ("gpu0", "gpu0"))):
        for n in SIZES:
            res = {}
            for policy in ("reference", "rimms"):
                res[policy] = run_app(
                    lambda ctx, n=n: build_2fft(ctx, n, pins=pins),
                    policy=policy, repeats=repeats, device=device,
                )
            ref, rim = res["reference"], res["rimms"]
            eliminated = ref["copies"] - rim["copies"]
            expect = 1 if scen == "cpu_acc" else 3
            ok = "OK" if abs(eliminated - expect) < 1e-9 else "MISMATCH"
            emit(
                f"fig5_2fft_{scen}_n{n}",
                rim["wall_s"] * 1e6,
                f"ref_us={ref['wall_s']*1e6:.1f};copies {ref['copies']:.0f}->"
                f"{rim['copies']:.0f} (-{eliminated:.0f} expect {expect} {ok});"
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
