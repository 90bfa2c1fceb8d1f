"""The recurrent families' dry-run held to the JAX package's per-device
plan on the two-pod mesh (2 × 16 × 16, 512 fake ranks; the batch over
the pod and data axes), on the CPU: the one-group probe of xlstm-350m
and recurrentgemma-2b at their four shapes against the reference's
``--mesh multi`` records in
``src/repro_torch/launch/dryrun_reference.json`` (the sLSTM's scan
counted once, as the reference's): within the bounds, decode caches
written in place, the count complete (``tests/held_cells.py`` holds the
checks); and ``--held``, which runs each record's cell on the mesh its
name gives."""

import copy
import json

import pytest
import torch

from held_cells import (check_cover, check_decode_in_place,
                        check_within_bounds, ids, run_cells)
from make_dryrun_reference import cell_key
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

torch.set_num_threads(1)

CELLS = (
    ("xlstm_350m", "train_4k", "multi"),
    ("xlstm_350m", "prefill_32k", "multi"),
    ("xlstm_350m", "decode_32k", "multi"),
    ("xlstm_350m", "long_500k", "multi"),
    ("recurrentgemma_2b", "train_4k", "multi"),
    ("recurrentgemma_2b", "prefill_32k", "multi"),
    ("recurrentgemma_2b", "decode_32k", "multi"),
    ("recurrentgemma_2b", "long_500k", "multi"),
)
DECODE = [c for c in CELLS if SHAPES[c[1]].kind == "decode"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return run_cells(CELLS, tmp_path_factory.mktemp("dryrun_multipod_rec"),
                     jobs=4)


@pytest.fixture(scope="module")
def reference():
    return dryrun.reference_records()


@pytest.mark.parametrize("cell", CELLS, ids=ids(CELLS))
def test_cell_within_bounds_of_reference(port_run, reference, cell):
    records, stdout = port_run
    key = cell_key(*cell)
    check_within_bounds(key, records[key], stdout[key], reference[key])


@pytest.mark.parametrize("cell", DECODE, ids=ids(DECODE))
def test_decode_caches_written_in_place(port_run, reference, cell):
    key = cell_key(*cell)
    check_decode_in_place(port_run[0][key], reference[key])


@pytest.mark.parametrize("cell", CELLS, ids=ids(CELLS))
def test_count_covers_the_whole_step(port_run, cell):
    check_cover(port_run[0][cell_key(*cell)], cell[0], cell[1])


def test_held_runs_each_cell_on_the_mesh_its_name_gives(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """``--held`` (``dryrun.run_held``) runs each record's cell, a process
    a cell, on the mesh and probe of its name, prints a line of ratios
    each, and exits 1 when a cell misses a bound."""
    refs = dryrun.reference_records()
    names = [cell_key("recurrentgemma_2b", "decode_32k", m)
             for m in ("single", "multi")]
    held = {n: refs[n] for n in names}
    monkeypatch.setattr(dryrun, "reference_records", lambda: held)
    assert dryrun.run_held(tmp_path, jobs=2) == 0
    for name, ranks in zip(names, (256, 512)):
        rec = json.loads((tmp_path / f"{name}.json").read_text())
        assert (rec["mesh"], rec["n_devices"], rec["probe"]) == (
            name.split("__")[2], ranks, 1)
    out = capsys.readouterr().out
    assert all(f"[ref ] {n}:" in out for n in names)
    assert "[held] 2 of 2 cells within bounds" in out
    # a reference of a quarter of the FLOPs: the port's record misses
    held[names[1]] = copy.deepcopy(held[names[1]])
    held[names[1]]["cost"]["flops"] /= 4
    assert dryrun.run_held(tmp_path, jobs=2) == 1
    assert "[held] 1 of 2 cells within bounds" in capsys.readouterr().out
