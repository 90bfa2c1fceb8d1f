"""Roofline terms per (arch × shape) from the port's dry-run artifacts
(``python -m repro_torch.launch.dryrun --sweep --probes``), the JAX
package's ``benchmarks/bench_roofline.py`` — emitted as CSV rows, one
per cell with a full record and both probes.  The times are computed
from counts and the H100's constants, not measured."""

from __future__ import annotations

from .common import emit


def run() -> None:
    from repro_torch.launch.roofline import full_table

    rows = full_table()
    for r in rows:
        emit(
            f"roofline_{r['arch']}_{r['shape']}",
            r["bound_s"] * 1e6,
            f"bottleneck={r['bottleneck']};frac={r['roofline_fraction']:.3f};"
            f"useful={r['useful_ratio']:.2f};GiB/dev={r['mem_per_device_GiB']:.2f};"
            f"multi={'y' if r['multi_ok'] else 'n'}",
        )
    if not rows:
        emit("roofline_missing", 0.0,
             "run repro_torch.launch.dryrun --sweep --probes first")


if __name__ == "__main__":
    run()
