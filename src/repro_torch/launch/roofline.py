"""Roofline derivation from the port's dry-run artifacts, the JAX
package's ``src/repro/launch/roofline.py`` with the H100's constants.

Per (arch × shape) cell on the single-pod mesh:

  compute    = FLOPs_dev / 989 TF/s          (bf16 dense, H100 SXM)
  memory     = bytes_dev / 3.35 TB/s         (HBM3)
  collective = algo_bytes_dev / 50 GB/s      (400 Gb/s NIC per GPU)

All three per-device quantities come from the 1-vs-2-group probe runs,
extrapolated ``c1 + (G_eff − 1)(c2 − c1)``, as the reference builds its
tables.  The reference adds the sLSTM's ``recurrent_correction_flops``
because XLA counts a loop body once; the port runs and counts every
step, so nothing is added here.

Definitions reported per cell:
  bound          = max(compute, memory, collective)   — step-time lower bound
  bottleneck     = argmax term
  MODEL_FLOPS    = 6·N_active·tokens (train) / 2·N_active·tokens (fwd)
  useful_ratio   = MODEL_FLOPS / (FLOPs_dev · n_dev)
  roofline_frac  = (MODEL_FLOPS / n_dev / peak) / bound

These are computed from counts, not measured.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12  # bf16 dense FLOP/s per H100 SXM (data sheet)
HBM_BW = 3.35e12     # B/s per H100 SXM (HBM3)
#: B/s per GPU across a 16-wide mesh axis: each spans at least two 8-GPU
#: NVLink nodes, so its ring runs at the 400 Gb/s NIC (NVLink 4 inside a
#: node gives 450 GB/s per direction)
LINK_BW = 50e9

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def _load(name: str, out_dir: Path) -> Optional[dict]:
    p = out_dir / (name + ".json")
    if not p.exists():
        return None
    rec = json.loads(p.read_text())
    return None if "error" in rec else rec


def cell_roofline(arch: str, shape: str,
                  out_dir: Path = DRYRUN_DIR) -> Optional[Dict]:
    full = _load(f"{arch}__{shape}__single", out_dir)
    p1 = _load(f"{arch}__{shape}__single__p1", out_dir)
    p2 = _load(f"{arch}__{shape}__single__p2", out_dir)
    if not (full and p1 and p2):
        return None
    eff = full["eff_groups"]
    n_dev = full["n_devices"]

    def extrap(get):
        c1, c2 = get(p1), get(p2)
        return c1 + (eff - 1) * (c2 - c1)

    flops = extrap(lambda r: r["cost"]["flops"])
    mem_bytes = extrap(lambda r: r["cost"]["bytes_accessed"])
    coll_bytes = extrap(lambda r: r["collectives"]["algorithm_bytes"])

    t_c = flops / PEAK_FLOPS
    t_m = mem_bytes / HBM_BW
    t_l = coll_bytes / LINK_BW
    bound = max(t_c, t_m, t_l)
    bn = {t_c: "compute", t_m: "memory", t_l: "collective"}[bound]
    mf = full["model_flops"]
    useful = mf / max(flops * n_dev, 1e-9)
    frac = (mf / n_dev / PEAK_FLOPS) / max(bound, 1e-12)
    return {
        "arch": arch, "shape": shape, "n_devices": n_dev,
        "flops_dev": flops, "mem_bytes_dev": mem_bytes,
        "coll_bytes_dev": coll_bytes,
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_l,
        "bound_s": bound, "bottleneck": bn,
        "model_flops": mf, "useful_ratio": useful,
        "roofline_fraction": frac,
        "mem_per_device_GiB": full["memory"]["per_device_total"] / 2 ** 30,
        "compile_s": full["compile_s"],
        "multi_ok": _load(f"{arch}__{shape}__multi", out_dir) is not None,
    }


def full_table(out_dir: Path = DRYRUN_DIR) -> List[Dict]:
    from repro_torch.configs.base import ARCH_IDS, cells_for

    rows = []
    for arch in ARCH_IDS:
        for shape in cells_for(arch):
            r = cell_roofline(arch, shape, out_dir)
            if r:
                rows.append(r)
    return rows


def markdown_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | bound s | "
           "bottleneck | useful | roofline-frac | GiB/dev | multi-pod |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4g} | "
            f"{r['t_memory_s']:.4g} | {r['t_collective_s']:.4g} | "
            f"{r['bound_s']:.4g} | {r['bottleneck']} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} | "
            f"{r['mem_per_device_GiB']:.2f} | "
            f"{'yes' if r['multi_ok'] else 'NO'} |\n"
        )
    return "".join(out)


def main() -> None:
    rows = full_table()
    print(markdown_table(rows))
    out = DRYRUN_DIR.parent / "roofline.md"
    out.write_text(markdown_table(rows))
    print(f"written {out} ({len(rows)} cells)")


if __name__ == "__main__":
    main()
