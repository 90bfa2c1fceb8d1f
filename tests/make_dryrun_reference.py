"""Write the JAX package's one-group dry-run figures that the port's
dry-run is held to (``src/repro_torch/launch/dryrun_reference.json``).

For each cell of :data:`CELLS` (every arch's shapes, on both meshes) it
runs the reference CLI in a subprocess, a few at a time,

    python -m repro.launch.dryrun --arch A --shape S --mesh M --probe 1

(512 host devices faked by XLA's flag; the 16 × 16 single-pod mesh or
the 2 × 16 × 16 two-pod one), and keeps the record's ``memory``,
``cost``, ``collectives`` (``algorithm_bytes``, ``by_op``, ``counts``,
``n_while_loops``) and ``eff_groups``, with the jax version that made
them.  At one group the reference unrolls its layers; only the sLSTM's
scan over time stays a while loop (``n_while_loops`` > 0), whose body
XLA's cost analysis and the collective parser count once.  The port
ships the file because ``chip_smoke.py`` reads it on a machine with no
JAX.

Not a test module.  Run from the repo's root (a few minutes on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_dryrun_reference.py
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

from repro_torch.configs.base import ARCH_IDS, cells_for

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "src" / "repro_torch" / "launch" / "dryrun_reference.json"

#: reference CLIs run at once
JOBS = 4
#: (arch, shape, mesh) of every one-group cell the port is held to
CELLS = tuple((a, s, m) for a in ARCH_IDS for s in cells_for(a)
              for m in ("single", "multi"))


def cell_key(arch: str, shape: str, mesh: str = "single") -> str:
    """The record's name, as both CLIs name its file."""
    return f"{arch}__{shape}__{mesh}__p1"


def reference_records(cells=CELLS, jobs: int = JOBS) -> dict:
    """{cell key: the fields of the reference CLI's one-group record} of
    each (arch, shape, mesh) of ``cells``, ``jobs`` CLIs at a time (the
    port's runner, ``dryrun.run_cells``, on the JAX package's CLI)."""
    from repro_torch.launch import dryrun

    with tempfile.TemporaryDirectory() as out:
        records, outputs = dryrun.run_cells(
            [cell_key(*c) for c in cells], Path(out), jobs, timeout=3600,
            module="repro.launch.dryrun", env={"JAX_PLATFORMS": "cpu"})
    kept = {}
    for key, rec in records.items():
        if "error" in rec:
            raise RuntimeError(f"reference dry-run of {key}: {rec['error']}"
                               f"\n{outputs.get(key, '')[-2000:]}")
        coll = rec["collectives"]
        kept[key] = {
            "memory": rec["memory"],
            "cost": rec["cost"],
            "collectives": {k: coll[k] for k in ("algorithm_bytes", "by_op",
                                                 "counts", "n_while_loops")},
            "eff_groups": rec["eff_groups"],
        }
    return kept


def reference_record(arch: str, shape: str, mesh: str = "single") -> dict:
    """The fields of the reference CLI's one-group record of a cell."""
    return reference_records(((arch, shape, mesh),), 1)[
        cell_key(arch, shape, mesh)]


def main() -> None:
    import jax

    doc = {"jax_version": jax.__version__,
           "command": "python -m repro.launch.dryrun --arch A --shape S "
                      "--mesh M --probe 1",
           "cells": reference_records()}
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
