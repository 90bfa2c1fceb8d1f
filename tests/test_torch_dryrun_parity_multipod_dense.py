"""The port's sharded steps held to the JAX package's per-device plan on
the two-pod mesh (2 × 16 × 16, 512 fake ranks; the batch over the pod
and data axes), on the CPU: the dry-run's one-group probe of the dense
and vision-language families' cells (llama3-8b, yi-9b,
command-r-plus-104b, qwen1.5-32b and internvl2-26b, each at its three
shapes) against the reference's ``--mesh multi`` records in
``src/repro_torch/launch/dryrun_reference.json``: within the bounds,
decode caches written in place (the token on 32 batch ranks), the count
complete (``tests/held_cells.py`` holds the checks)."""

import pytest
import torch

from held_cells import (check_cover, check_decode_in_place,
                        check_within_bounds, ids, run_cells)
from make_dryrun_reference import cell_key
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

torch.set_num_threads(1)

CELLS = (
    ("llama3_8b", "train_4k", "multi"),
    ("llama3_8b", "prefill_32k", "multi"),
    ("llama3_8b", "decode_32k", "multi"),
    ("yi_9b", "train_4k", "multi"),
    ("yi_9b", "prefill_32k", "multi"),
    ("yi_9b", "decode_32k", "multi"),
    ("command_r_plus_104b", "train_4k", "multi"),
    ("command_r_plus_104b", "prefill_32k", "multi"),
    ("command_r_plus_104b", "decode_32k", "multi"),
    ("qwen1_5_32b", "train_4k", "multi"),
    ("qwen1_5_32b", "prefill_32k", "multi"),
    ("qwen1_5_32b", "decode_32k", "multi"),
    ("internvl2_26b", "train_4k", "multi"),
    ("internvl2_26b", "prefill_32k", "multi"),
    ("internvl2_26b", "decode_32k", "multi"),
)
DECODE = [c for c in CELLS if SHAPES[c[1]].kind == "decode"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return run_cells(CELLS, tmp_path_factory.mktemp("dryrun_multipod_dense"),
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
