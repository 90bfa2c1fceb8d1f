"""What the dry-run parity files share (not a test module): the port's
dry-run CLI run on a set of one-group cells, a process a cell, a few at
a time, and the checks each file makes of each record against the JAX
package's (``src/repro_torch/launch/dryrun_reference.json``, written by
``tests/make_dryrun_reference.py``):

* within ``dryrun.BOUNDS`` of the reference's record, and the CLI's line
  of ratios with this torch's version;
* in decode, the caches written in place: the aliased bytes are every
  returned cache's, and the step's only output of its own is the token
  (B,) int32 on its batch ranks;
* the count complete: the FLOPs a device times the ranks reach
  :data:`COVER` of the same step's count on one device
  (``dryrun.count_world1``), loops counted whole."""

from pathlib import Path

import torch

from make_dryrun_reference import cell_key
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

#: the per-device count times the ranks, at least this share of one
#: device's count of the same step
COVER = 0.95
#: (arch, shape) of the eight single-pod cells held first: the dense and
#: MoE families at their three shapes, the recurrent families' decode
FIRST_CELLS = (
    ("llama3_8b", "decode_32k"),
    ("llama3_8b", "prefill_32k"),
    ("llama3_8b", "train_4k"),
    ("granite_moe_3b_a800m", "decode_32k"),
    ("granite_moe_3b_a800m", "prefill_32k"),
    ("granite_moe_3b_a800m", "train_4k"),
    ("xlstm_350m", "decode_32k"),
    ("recurrentgemma_2b", "decode_32k"),
)


def ids(cells):
    return ["-".join(c) for c in cells]


def run_cells(cells, out: Path, jobs: int = 4, timeout: float = 900):
    """The dry-run CLI at ``--probe 1`` on each (arch, shape, mesh) of
    ``cells``, ``jobs`` processes at a time (``dryrun.run_cells``): ({cell
    key: record}, {cell key: the CLI's output}).  Every process exits 0
    within ``timeout`` seconds of the first's start."""
    records, stdout = dryrun.run_cells(
        [cell_key(*c) for c in cells], out, jobs, timeout=timeout)
    for key, rec in records.items():
        assert "exit" not in rec, (rec["error"], stdout.get(key, "")[-2000:])
    return records, stdout


def check_within_bounds(key, rec, stdout, ref):
    assert "error" not in rec, rec.get("error")
    assert dryrun.against_reference(rec, ref) == []
    # the CLI printed the four ratios and the torch version
    line = next(x for x in stdout.splitlines()
                if x.startswith(f"[ref ] {key}:"))
    for k in dryrun.BOUNDS:
        assert f"{k} " in line
    assert f"torch {torch.__version__}" in line
    assert line.endswith("within bounds")


def check_decode_in_place(rec, ref):
    """The serve step writes the caches it is given: its aliased bytes
    are every returned cache's, and the only output of its own is the
    next token, (B,) int32 on each of its batch ranks (every rank but the
    16 of the model axis) or whole where they do not divide B."""
    mem = rec["memory"]
    caches = dryrun.returned_cache_bytes(rec)
    assert mem["alias_size_in_bytes"] == caches > 0
    B = SHAPES[rec["shape"]].global_batch
    batch_ranks = rec["n_devices"] // 16
    token = 4 * (B // batch_ranks if B % batch_ranks == 0 else B)
    assert mem["output_size_in_bytes"] - caches == token
    assert ref["memory"]["alias_size_in_bytes"] > 0  # the reference's too


def check_cover(rec, arch, shape):
    """What a rank runs, times the ranks, is at least the step's work on
    one device: no op of the step escapes the per-device count."""
    whole = dryrun.count_world1(arch, shape, probe_groups=1)
    assert rec["cost"]["flops"] * rec["n_devices"] >= COVER * whole["flops"]
