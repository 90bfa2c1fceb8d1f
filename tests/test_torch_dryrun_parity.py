"""The port's sharded steps held to the JAX package's per-device plan, on
the CPU: the dry-run's one-group probe (``--probe 1 --mesh single``, 256
fake ranks) of the first eight cells against the reference's records
committed in ``src/repro_torch/launch/dryrun_reference.json`` (written by
``tests/make_dryrun_reference.py``, which holds every cell on both
meshes; the other files ``tests/test_torch_dryrun_parity_*.py`` hold the
rest).  At one group the reference unrolls its layers, and its only while
loops are the sLSTM's scan (``n_while_loops`` > 0), whose body the port's
record is compared with once (``dryrun.loop_body_once``):

* each cell within ``dryrun.BOUNDS`` of the reference's (FLOPs a device
  ≤ 1.25×, collective algorithm bytes ≤ 2×, ``per_device_total`` ≤ 1.5×;
  in decode also ``bytes_accessed`` ≤ 2×), and the CLI's line of ratios;
* in decode, the caches written in place: the aliased bytes are every
  returned cache's, as the reference's donated caches;
* the count complete: the FLOPs a device times the 256 ranks reach 0.95
  of the same step's count on one device (``dryrun.count_world1``);
* ``against_reference`` naming each bound a record misses;
* the committed figures current: the reference CLI rerun on one cell
  gives the file's fields.

The bounds are one-sided: a port that does less a device than GSPMD is
not at fault, and the completeness check guards the count itself."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import make_dryrun_reference
from held_cells import FIRST_CELLS as CELLS
from make_dryrun_reference import cell_key, reference_record
from repro_torch.launch import dryrun

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DECODE = [c for c in CELLS if c[1] == "decode_32k"]
#: the per-device count times the ranks, at least this share of one
#: device's count of the same step
COVER = 0.95


def _ids(cells):
    return [f"{a}-{s}" for a, s in cells]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The dry-run CLI on every cell (a process a cell, four at a time):
    ({cell key: record}, {cell key: the CLI's output})."""
    out = tmp_path_factory.mktemp("dryrun_parity")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    records, stdout = {}, {}
    for start in range(0, len(CELLS), 4):
        procs = [(cell_key(a, s), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", s, "--mesh", "single", "--probe", "1", "--out",
             str(out), "--no-skip-existing"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
            for a, s in CELLS[start:start + 4]]
        for key, proc in procs:
            stdout[key], _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout[key][-2000:]
            records[key] = json.loads((out / f"{key}.json").read_text())
    return records, stdout


@pytest.fixture(scope="module")
def reference():
    return dryrun.reference_records()


def test_reference_file_holds_every_cell(reference):
    """Every (arch, shape) on both meshes; every op counted (no while
    loop) but the sLSTM's scan over time, forward and in training
    backward."""
    assert sorted(reference) == sorted(
        cell_key(*c) for c in make_dryrun_reference.CELLS)
    assert len(reference) == 64
    for key, rec in reference.items():
        arch, shape = key.split("__")[:2]
        loops = {"train_4k": 2, "prefill_32k": 1}.get(shape, 0) \
            if arch == "xlstm_350m" else 0
        assert rec["collectives"]["n_while_loops"] == loops, key


@pytest.mark.parametrize("cell", CELLS, ids=_ids(CELLS))
def test_cell_within_bounds_of_reference(port_run, reference, cell):
    records, stdout = port_run
    key = cell_key(*cell)
    rec = records[key]
    assert "error" not in rec, rec.get("error")
    assert dryrun.against_reference(rec, reference[key]) == []
    # the CLI printed the four ratios and the torch version
    line = next(x for x in stdout[key].splitlines()
                if x.startswith(f"[ref ] {key}:"))
    for k in dryrun.BOUNDS:
        assert f"{k} " in line
    assert f"torch {torch.__version__}" in line
    assert line.endswith("within bounds")


@pytest.mark.parametrize("cell", DECODE, ids=_ids(DECODE))
def test_decode_caches_written_in_place(port_run, reference, cell):
    """The serve step writes the caches it is given: its aliased bytes
    are every returned cache's, and the only output of its own is the
    next token."""
    rec = port_run[0][cell_key(*cell)]
    mem = rec["memory"]
    caches = dryrun.returned_cache_bytes(rec)
    assert mem["alias_size_in_bytes"] == caches > 0
    assert mem["output_size_in_bytes"] - caches == 4 * 128 // 16
    ref = reference[cell_key(*cell)]["memory"]
    assert ref["alias_size_in_bytes"] > 0  # the reference's donate too


@pytest.mark.parametrize("cell", CELLS, ids=_ids(CELLS))
def test_count_covers_the_whole_step(port_run, cell):
    """What a rank runs, times the ranks, is at least the step's work on
    one device: no op of the step escapes the per-device count."""
    rec = port_run[0][cell_key(*cell)]
    whole = dryrun.count_world1(*cell, probe_groups=1)
    assert rec["cost"]["flops"] * rec["n_devices"] >= COVER * whole["flops"]


def test_against_reference_names_each_missed_bound(reference):
    """Decode: every bound and the aliasing; training: no bytes bound."""
    for key, held in ((cell_key("llama3_8b", "decode_32k"), 5),
                      (cell_key("llama3_8b", "train_4k"), 3)):
        ref = reference[key]
        arch, shape = key.split("__")[:2]
        rec = {"arch": arch, "shape": shape, "mesh": "single", "probe": 1,
               "n_devices": 256,
               "cost": {"flops": ref["cost"]["flops"] * 1.3,
                        "bytes_accessed": ref["cost"]["bytes_accessed"]
                        * 2.1},
               "collectives": {"algorithm_bytes":
                               ref["collectives"]["algorithm_bytes"] * 2.1},
               "memory": dict(ref["memory"], alias_size_in_bytes=0,
                              per_device_total=ref["memory"]
                              ["per_device_total"] * 1.6)}
        misses = dryrun.against_reference(rec, ref)
        assert len(misses) == held, misses
        rec["cost"] = dict(ref["cost"])
        rec["collectives"] = dict(ref["collectives"])
        rec["memory"] = dict(ref["memory"], output_size_in_bytes=ref[
            "memory"]["alias_size_in_bytes"] + 4 * 128 // 16)
        assert dryrun.against_reference(rec, ref) == []


def test_returned_cache_bytes_leave_out_the_token():
    """The token is (B,) int32 sharded over the batch's 16 ranks, or
    whole where they do not divide B (long_500k's batch of 1)."""
    for shape, token in (("decode_32k", 4 * 128 // 16), ("long_500k", 4)):
        rec = {"shape": shape, "n_devices": 256,
               "memory": {"output_size_in_bytes": 1000 + token}}
        assert dryrun.returned_cache_bytes(rec) == 1000


def test_reference_figures_are_current(reference):
    """The reference CLI, rerun on one cell, gives the committed fields."""
    key = cell_key("llama3_8b", "decode_32k")
    assert reference_record("llama3_8b", "decode_32k") == reference[key]
