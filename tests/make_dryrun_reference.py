"""Write the JAX package's one-group dry-run figures that the port's
dry-run is held to (``src/repro_torch/launch/dryrun_reference.json``).

For each cell of :data:`CELLS` it runs the reference CLI in a subprocess,

    python -m repro.launch.dryrun --arch A --shape S --mesh single --probe 1

(512 host devices faked by XLA's flag, the 16 × 16 single-pod mesh), and
keeps the record's ``memory``, ``cost``, ``collectives`` (``algorithm_bytes``,
``by_op``, ``counts``, ``n_while_loops``) and ``eff_groups``, with the jax
version that made them.  At one group the reference compiles no while
loop, so XLA's cost and memory analyses count every op.  The port ships
the file because ``chip_smoke.py`` reads it on a machine with no JAX.

Not a test module.  Run from the repo's root (about a minute on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_dryrun_reference.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "src" / "repro_torch" / "launch" / "dryrun_reference.json"

#: (arch, shape) of every one-group cell the port is held to
CELLS = (
    ("llama3_8b", "decode_32k"),
    ("llama3_8b", "prefill_32k"),
    ("llama3_8b", "train_4k"),
    ("granite_moe_3b_a800m", "decode_32k"),
    ("granite_moe_3b_a800m", "prefill_32k"),
    ("granite_moe_3b_a800m", "train_4k"),
    ("xlstm_350m", "decode_32k"),
    ("recurrentgemma_2b", "decode_32k"),
)


def cell_key(arch: str, shape: str) -> str:
    """The record's name, as both CLIs name its file."""
    return f"{arch}__{shape}__single__p1"


def reference_record(arch: str, shape: str) -> dict:
    """The fields of the reference CLI's one-group record of a cell."""
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", "single", "--probe", "1", "--out",
             out, "--no-skip-existing"],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(REPO / "src"),
                 "JAX_PLATFORMS": "cpu"})
        if proc.returncode != 0:
            raise RuntimeError(f"reference dry-run of {arch} {shape} exited "
                               f"{proc.returncode}: {proc.stderr[-2000:]}")
        rec = json.loads((Path(out) / f"{cell_key(arch, shape)}.json")
                         .read_text())
    if "error" in rec:
        raise RuntimeError(f"reference dry-run of {arch} {shape}: "
                           f"{rec['error']}")
    coll = rec["collectives"]
    return {
        "memory": rec["memory"],
        "cost": rec["cost"],
        "collectives": {k: coll[k] for k in ("algorithm_bytes", "by_op",
                                             "counts", "n_while_loops")},
        "eff_groups": rec["eff_groups"],
    }


def main() -> None:
    import jax

    doc = {"jax_version": jax.__version__,
           "command": "python -m repro.launch.dryrun --arch A --shape S "
                      "--mesh single --probe 1",
           "cells": {}}
    for arch, shape in CELLS:
        print(f"[ref ] {arch} {shape}", flush=True)
        doc["cells"][cell_key(arch, shape)] = reference_record(arch, shape)
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
