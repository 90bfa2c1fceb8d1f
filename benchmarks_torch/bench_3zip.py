"""Paper Fig 8: 3ZIP across runtimes on GPU-only — CEDR-style reference,
RIMMS, and a native chain as the CUDA analogue.

Sizes 2^7 .. 2^17.  The CUDA version in the paper keeps intermediates on
device; so does the native chain here, ``(a*b)*(c*d)`` in torch ops on
tensors already on the device, then a synchronise (the reference's
analogue is a fused ``jax.jit`` chain, XLA outside any Pallas kernel) —
so "RIMMS tracks CUDA" maps to RIMMS wall/modeled time approaching the
native floor.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_3zip [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .common import emit, run_app

SIZES = tuple(2 ** k for k in (7, 9, 11, 13, 15, 17))


def _native_3zip(a, b, c, d):
    return (a * b) * (c * d)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(repeats: int = 5, device=None) -> None:
    from repro_torch.apps.radar import build_3zip
    from repro_torch.core.runtime import resolve_device

    dev = resolve_device(device)

    for n in SIZES:
        res = {}
        for policy in ("reference", "rimms"):
            res[policy] = run_app(
                lambda ctx, n=n: build_3zip(ctx, n, pins=("gpu0",) * 3),
                policy=policy, repeats=repeats, device=device,
            )
        # native analogue: the operands already on the device
        rng = np.random.default_rng(0)
        arrs = [torch.from_numpy((rng.normal(size=n)
                                  + 1j * rng.normal(size=n))
                                 .astype(np.complex64)).to(dev)
                for _ in range(4)]
        _native_3zip(*arrs)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            _native_3zip(*arrs)
            _sync(dev)
        fused = (time.perf_counter() - t0) / repeats
        ref, rim = res["reference"], res["rimms"]
        emit(
            f"fig8_3zip_n{n}", rim["wall_s"] * 1e6,
            f"ref_us={ref['wall_s']*1e6:.1f};fused_us={fused*1e6:.1f};"
            f"spdup_vs_ref={ref['wall_s']/max(rim['wall_s'],1e-12):.2f}x;"
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
