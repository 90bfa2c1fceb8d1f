"""The recurrent families' dry-run held to the JAX package's per-device
plan, on the CPU: the one-group probe of the xlstm-350m and
recurrentgemma-2b single-pod cells that ``tests/test_torch_dryrun_parity.py``
leaves out (training, prefill and the 524 288-token decode of a batch of
one) against the reference's records in
``src/repro_torch/launch/dryrun_reference.json`` (``tests/held_cells.py``
holds the checks), and the sLSTM's loop over time as the dry-run counts
it:

* ``dryrun._OneStep`` runs a loop's first two steps and counts the
  second for every other; at the smoke config's S = 64, on a 2 × 2 fake
  mesh, that count equals the full loop's field by field (FLOPs, bytes,
  transcendentals, the peak of live bytes, collectives by op and their
  counts) in training, prefill and decode;
* a record whose reference holds while loops (``n_while_loops`` > 0,
  the sLSTM's scan) is compared with each loop's body counted once, as
  XLA counts it; one without is compared with its complete count."""

import copy

import pytest
import torch

from held_cells import (check_cover, check_decode_in_place,
                        check_within_bounds, ids, run_cells)
from make_dryrun_reference import cell_key
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

torch.set_num_threads(1)

CELLS = (
    ("xlstm_350m", "train_4k", "single"),
    ("xlstm_350m", "prefill_32k", "single"),
    ("xlstm_350m", "long_500k", "single"),
    ("recurrentgemma_2b", "train_4k", "single"),
    ("recurrentgemma_2b", "prefill_32k", "single"),
    ("recurrentgemma_2b", "long_500k", "single"),
)
DECODE = [c for c in CELLS if SHAPES[c[1]].kind == "decode"]
#: the sLSTM cells' while loops in the reference's one-group records:
#: the forward scan, and in training the backward one
WHILE_LOOPS = {"train_4k": 2, "prefill_32k": 1, "decode_32k": 0,
               "long_500k": 0}


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return run_cells(CELLS, tmp_path_factory.mktemp("dryrun_recurrent"),
                     jobs=3)


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


@pytest.mark.parametrize("cell", CELLS, ids=ids(CELLS))
def test_slstm_loops_recorded_as_the_reference_counts_them(
        port_run, reference, cell):
    """The port records one loop a while loop of the reference's: its
    step count and one step's figures."""
    key = cell_key(*cell)
    rec = port_run[0][key]
    n = reference[key]["collectives"]["n_while_loops"]
    if cell[0] == "xlstm_350m":
        assert n == WHILE_LOOPS[cell[1]]
        steps = SHAPES[cell[1]].seq_len if n else 1
        assert [lp["steps"] for lp in rec["loops"]] == \
            [steps] * max(n, 1)
        for lp in rec["loops"]:
            assert lp["flops"] > 0 and lp["bytes_accessed"] > 0
    else:
        assert n == 0 and rec["loops"] == []


def _count(kind, one_step):
    """The smoke xlstm's step of S = 64 on a 2 × 2 fake mesh under the
    dry-run's counter, its loops run whole or counted from two steps."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.hlo_analysis import collective_stats
    from repro_torch.launch.mesh import make_local_mesh, rules_for_mesh
    from repro_torch.launch.specs import input_shardings, input_specs
    from repro_torch.models import build_model, recurrent

    cfg = get_config("xlstm_350m").smoke()
    shape = ShapeSpec("loop", kind, 64, 4)
    dryrun.fake_world(4)
    try:  # the fake group is this process's only while it counts
        mesh = make_local_mesh(2, 2, "cpu")
        rules = rules_for_mesh(mesh)
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        with use_rules(rules):
            model = build_model(cfg)
            inputs = [dryrun._dtensors(s, sh, fake_mode) for s, sh in zip(
                input_specs(cfg, shape), input_shardings(cfg, shape, rules))]
            step, _ = dryrun._cell_step(model, "xlstm_350m", shape, True, 2)
            cost = dryrun._LocalCost(fake_mode)
            for n in dryrun._local_bytes(inputs).values():
                cost.live += n
            cost.peak = cost.live
            hook = dryrun._OneStep(cost)
            recurrent.TIME_LOOP = hook if one_step else None
            try:
                with implicit_replication(), cost, dryrun._GspmdLike():
                    step(*inputs)
            finally:
                recurrent.TIME_LOOP = None
    finally:
        torch.distributed.destroy_process_group()
    coll = collective_stats(cost.events)
    return ({"flops": cost.flops, "bytes_accessed": cost.bytes,
             "transcendentals": cost.transcendentals, "peak": cost.peak,
             "by_op": coll.by_op, "counts": coll.counts}, hook.loops)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_slstm_loop_counted_from_two_steps_equals_the_full_loop(kind):
    scaled, loops = _count(kind, True)
    full, _ = _count(kind, False)
    assert scaled == full
    steps = 1 if kind == "decode" else 64
    assert [lp["steps"] for lp in loops] == \
        [steps] * (2 if kind == "train" else 1)


def test_while_loop_rule_counts_the_body_once(reference):
    """Against a reference with while loops each loop is taken out but
    for one step; against one without, the complete count is held."""
    key = cell_key("xlstm_350m", "prefill_32k")
    ref = reference[key]
    assert ref["collectives"]["n_while_loops"] == 1
    step = {"flops": 1e9, "bytes_accessed": 2e9, "transcendentals": 0.0,
            "collective_bytes": 3e6, "steps": 32768, "by_op": {}}
    rec = {"arch": "xlstm_350m", "shape": "prefill_32k", "mesh": "single",
           "probe": 1, "n_devices": 256,
           "cost": {"flops": ref["cost"]["flops"] + 32767 * 1e9,
                    "bytes_accessed": ref["cost"]["bytes_accessed"]
                    + 32767 * 2e9},
           "collectives": {"algorithm_bytes": ref["collectives"]
                           ["algorithm_bytes"] + 32767 * 3e6},
           "memory": dict(ref["memory"]), "loops": [step]}
    body = dryrun.loop_body_once(rec, ref)
    assert body == {"flops": ref["cost"]["flops"],
                    "collective_bytes": ref["collectives"]["algorithm_bytes"],
                    "bytes_accessed": ref["cost"]["bytes_accessed"]}
    assert all(abs(v - 1.0) < 1e-9 for v in dryrun.ratios(rec, ref).values())
    assert dryrun.against_reference(rec, ref) == []
    # the same record against a reference that counted every step: the
    # complete count, far past the bounds
    whole = copy.deepcopy(ref)
    whole["collectives"]["n_while_loops"] = 0
    assert dryrun.loop_body_once(rec, whole) == {
        "flops": rec["cost"]["flops"],
        "collective_bytes": rec["collectives"]["algorithm_bytes"],
        "bytes_accessed": rec["cost"]["bytes_accessed"]}
    assert len(dryrun.against_reference(rec, whole)) == 2
