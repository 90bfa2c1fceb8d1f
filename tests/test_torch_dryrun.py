"""The port's dry-run, roofline and launcher flags, held against the JAX
package's on the CPU (``tests/test_dryrun_integration.py`` on the port,
and more):

* the dry-run CLI on the reference test's cell in a subprocess (256 fake
  ranks need a process of their own): its record's fields, file name and
  signs, and the probe extrapolation equal to the full cell's counts;
* the per-device FLOP rule on hand-sized ops, and the collectives DTensor
  issues, on a ``fake`` process group of 16 ranks in this process;
* the collective formulas against the reference's HLO parser;
* both packages' ``cell_roofline`` on the same synthetic records;
* ``launch.train --distributed`` on a one-rank gloo group against the
  run without the flag, and a world above one refused."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCH_IDS, cells_for

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CELL = ("xlstm-350m", "decode_32k")

#: the fields of the reference's record (``repro.launch.dryrun.lower_cell``)
RECORD_FIELDS = {
    "arch", "shape", "mesh", "n_devices", "probe", "eff_groups", "lower_s",
    "compile_s", "memory", "cost", "collectives", "collective_schedule",
    "dropped_shardings", "model_flops", "recurrent_correction_flops",
    "params_total", "params_active", "loops"}
MEMORY_FIELDS = {
    "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
    "generated_code_size_in_bytes", "alias_size_in_bytes",
    "per_device_total"}


@pytest.fixture(scope="module")
def cell_records(tmp_path_factory):
    """The CLI on the reference test's cell, with its probes."""
    out = tmp_path_factory.mktemp("dryrun")
    arch, shape = CELL
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--probes", "--out",
         str(out), "--no-skip-existing"],
        cwd=REPO, capture_output=True, text=True, timeout=420,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


@pytest.mark.parametrize("cell", [CELL])
def test_dryrun_cell_subprocess(cell_records, cell):
    arch, shape = cell
    out = cell_records / f"{arch.replace('-', '_')}__{shape}__single.json"
    rec = json.loads(out.read_text())
    assert "error" not in rec, rec.get("error")
    assert rec["n_devices"] == 256  # single-pod = 16×16
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["per_device_total"] > 0
    assert rec["collectives"]["algorithm_bytes"] >= 0
    assert set(rec) == RECORD_FIELDS
    assert set(rec["memory"]) == MEMORY_FIELDS
    assert set(rec["cost"]) == {"flops", "bytes_accessed", "transcendentals"}
    assert set(rec["collectives"]) == {"algorithm_bytes", "by_op", "counts",
                                       "n_while_loops"}
    # the analytic fields are the reference's
    from repro.configs.base import SHAPES, get_config
    from repro.models.model_api import build_model

    jm = build_model(get_config(arch.replace("-", "_")))
    assert rec["model_flops"] == jm.model_flops(SHAPES[shape])
    assert rec["params_total"] == jm.param_counts()["total"]


def test_probe_extrapolation_equals_full_count(cell_records):
    """Every group of the cell is the same, and the port counts every
    layer: c1 + (G - 1)(c2 - c1) is the full cell's count."""
    arch, shape = CELL
    name = f"{arch.replace('-', '_')}__{shape}__single"
    full, p1, p2 = (json.loads((cell_records / f"{name}{s}.json").read_text())
                    for s in ("", "__p1", "__p2"))
    g = full["eff_groups"]
    assert (p1["probe"], p2["probe"], g) == (1, 2, 12)
    for get in (lambda r: r["cost"]["flops"],
                lambda r: r["cost"]["bytes_accessed"],
                lambda r: r["cost"]["transcendentals"],
                lambda r: r["collectives"]["algorithm_bytes"]):
        c1, c2 = get(p1), get(p2)
        assert c2 > c1 > 0 or get(full) == 0
        assert c1 + (g - 1) * (c2 - c1) == get(full)


# ---------------------------------------------------------------------------
# the per-device rule on hand-sized ops (16 fake ranks in this process)
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh_4x4():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    yield make_mesh((4, 4), ("data", "model"), "cpu")
    dist.destroy_process_group()


def _count(mesh, fn, *specs):
    """FLOPs and collective events rank 0 runs for ``fn`` of DTensors of
    fake tensors ``(shape, placements)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import tensor as dt

    from repro_torch.launch.dryrun import _LocalCost

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with fm:
        xs = [dt.empty(shape, device_mesh=mesh, placements=pl)
              for shape, pl in specs]
    cost = _LocalCost(fm)
    with cost:
        out = fn(*xs)
    return cost, out


def test_flop_rule_on_hand_sized_ops(mesh_4x4):
    """Per device = global FLOPs / the product of the mesh dims on which
    the op's output is Shard or Partial; an op replicated on a dim runs
    on every rank of it."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    M, K, N = 64, 32, 48
    glob = 2 * M * K * N
    # rows on data, columns on model: output (Shard(0), Shard(1))
    cost, out = _count(mesh_4x4, torch.mm, ((M, K), [Shard(0), Replicate()]),
                       ((K, N), [Replicate(), Shard(1)]))
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert cost.flops == glob / 16 and not cost.events
    # the contraction on model: output (Replicate(), Partial()) — the
    # product is done on all 4 data ranks alike
    cost, out = _count(mesh_4x4, torch.mm, ((M, K), [Replicate(), Shard(1)]),
                       ((K, N), [Replicate(), Shard(0)]))
    assert tuple(out.placements) == (Replicate(), Partial())
    assert cost.flops == glob / 4
    # elementwise, rows on data, replicated on model: 1 FLOP an element
    cost, out = _count(mesh_4x4, torch.add,
                       ((M, N), [Shard(0), Replicate()]),
                       ((M, N), [Shard(0), Replicate()]))
    assert tuple(out.placements) == (Shard(0), Replicate())
    assert cost.flops == M * N / 4
    # a transcendental is counted apart
    cost, _ = _count(mesh_4x4, torch.exp, ((M, N), [Shard(0), Shard(1)]))
    assert (cost.flops, cost.transcendentals) == (0, M * N / 16)


def test_collectives_dtensor_issues(mesh_4x4):
    """A redistribution's collective is recorded with its local bytes and
    group, and sized by the reference's formulas."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.launch.hlo_analysis import collective_stats

    M, N = 64, 48
    cost, _ = _count(mesh_4x4, lambda x: x.redistribute(
        mesh_4x4, [Replicate(), Replicate()]),
        ((M, N), [Shard(0), Replicate()]))
    (ev,) = cost.events
    assert (ev.op, ev.group_size) == ("all-gather", 4)
    assert (ev.operand_bytes, ev.result_bytes) == (M * N, M * N * 4)
    assert collective_stats(cost.events).total_algorithm_bytes == \
        M * N * 4 * 3 / 4
    cost, _ = _count(mesh_4x4, lambda x: x.redistribute(
        mesh_4x4, [Replicate(), Replicate()]),
        ((M, N), [Replicate(), Partial()]))
    (ev,) = cost.events
    assert (ev.op, ev.operand_bytes, ev.group_size) == (
        "all-reduce", M * N * 4, 4)


def test_gspmd_like_reshards_where_dtensor_refuses(mesh_4x4):
    """A view that splits a sharded dim off its shard boundaries
    replicates that dim first (8 KV heads of 16 on a 4-wide axis:
    heads 2 a shard would do, heads 8 of 2 a shard would not), and a
    product's pending sum is reduced before the product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import tensor as dt
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.launch.dryrun import _fit_for_view, _GspmdLike

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with fm:
        x = dt.empty(8, 128, device_mesh=mesh_4x4,
                     placements=[Shard(0), Shard(1)])
    view = torch.ops.aten.view.default
    assert _fit_for_view(view, x, (8, 8, 16)) is x      # 8 heads % 4 == 0
    y = _fit_for_view(view, x, (8, 2, 64))              # 2 heads on 4
    assert tuple(y.placements) == (Shard(0), Replicate())
    with fm:
        a = dt.empty(64, 32, device_mesh=mesh_4x4,
                     placements=[Shard(0), Partial()])
        w = dt.empty(32, 48, device_mesh=mesh_4x4,
                     placements=[Replicate(), Shard(1)])
    with _GspmdLike():
        out = torch.mm(a, w)
    assert tuple(out.placements) == (Shard(0), Shard(1))


def test_collective_formulas_match_reference():
    """The same collectives through the reference's HLO parser and the
    port's events give the same algorithm bytes, counts and result
    bytes."""
    from repro.launch.hlo_analysis import collective_stats as jax_stats

    from repro_torch.launch.hlo_analysis import (CollectiveEvent,
                                                 collective_stats)

    hlo = "\n".join([
        "%p0 = f32[64,128]{1,0} parameter(0)",
        "%ar = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %p0), "
        "replica_groups=[16,16]<=[256], to_apply=%add",
        "%ag = f32[1024,128]{1,0} all-gather(f32[64,128]{1,0} %p0), "
        "replica_groups=[16,16]<=[256], dimensions={0}",
        "%rs = f32[4,128]{1,0} reduce-scatter(f32[64,128]{1,0} %p0), "
        "replica_groups=[16,16]<=[256], dimensions={0}, to_apply=%add",
        "%aa = f32[64,128]{1,0} all-to-all(f32[64,128]{1,0} %p0), "
        "replica_groups=[16,16]<=[256], dimensions={0}",
    ])
    b = 64 * 128 * 4
    events = [CollectiveEvent("all-reduce", b, b, 16),
              CollectiveEvent("all-gather", b, 16 * b, 16),
              CollectiveEvent("reduce-scatter", b, b // 16, 16),
              CollectiveEvent("all-to-all", b, b, 16)]
    want, got = jax_stats(hlo, n_devices=256), collective_stats(events)
    assert got.by_op == want.by_op
    assert got.counts == want.counts
    assert got.result_bytes == want.result_bytes
    assert got.total_algorithm_bytes == want.total_algorithm_bytes


# ---------------------------------------------------------------------------
# the roofline on synthetic records
# ---------------------------------------------------------------------------


def _write_records(out: Path):
    """A full single, p1, p2 and multi record for every cell, with made-up
    counts; the sLSTM correction nonzero for the ssm arch's train cell."""
    rng = np.random.default_rng(7)
    for arch in ARCH_IDS:
        for shape in cells_for(arch):
            base = {"arch": arch, "shape": shape, "n_devices": 256,
                    "eff_groups": int(rng.integers(2, 40)),
                    "compile_s": 1.5,
                    "model_flops": float(rng.integers(1, 1 << 40)) * 1e3,
                    "recurrent_correction_flops": (
                        3e14 if arch == "xlstm_350m" and shape == "train_4k"
                        else 0.0),
                    "memory": {"per_device_total": int(rng.integers(
                        1 << 30, 1 << 36))}}
            for sfx, k in (("", 5), ("__p1", 1), ("__p2", 2),
                           ("multi", 5)):
                rec = dict(base, cost={
                    "flops": 1e12 * k * (1 + rng.random()),
                    "bytes_accessed": 1e10 * k * (1 + rng.random())},
                    collectives={"algorithm_bytes": 1e9 * k * rng.random()})
                name = (f"{arch}__{shape}__multi" if sfx == "multi"
                        else f"{arch}__{shape}__single{sfx}")
                (out / f"{name}.json").write_text(json.dumps(rec))


def test_roofline_table_generation(tmp_path, monkeypatch):
    """Dry-run artifacts yield a full roofline table; the same records
    through both packages' ``cell_roofline`` give equal FLOPs, bytes and
    ratios (the port adds no sLSTM correction: it counts every step), and
    times in the ratio of the two chips' constants."""
    from repro.launch import roofline as JR

    from benchmarks_torch import bench_roofline, common
    from repro_torch.launch import roofline as TR

    _write_records(tmp_path)
    rows = TR.full_table(tmp_path)
    expected = sum(len(cells_for(a)) for a in ARCH_IDS)
    assert len(rows) == expected == 32
    md = TR.markdown_table(rows)
    assert md.count("\n") == len(rows) + 2
    assert all(r["multi_ok"] for r in rows)
    assert all(r["bottleneck"] in ("compute", "memory", "collective")
               for r in rows)
    for r in rows:
        j = JR.cell_roofline(r["arch"], r["shape"], tmp_path)
        rec = json.loads((tmp_path / f"{r['arch']}__{r['shape']}__single"
                          ".json").read_text())
        corr = rec["recurrent_correction_flops"] / rec["n_devices"]
        assert r["flops_dev"] == j["flops_dev"] - corr
        assert (r["mem_bytes_dev"], r["coll_bytes_dev"]) == (
            j["mem_bytes_dev"], j["coll_bytes_dev"])
        if corr == 0:
            assert r["useful_ratio"] == j["useful_ratio"]
            assert r["t_compute_s"] == pytest.approx(
                j["t_compute_s"] * JR.PEAK_FLOPS / TR.PEAK_FLOPS, rel=1e-12)
        assert r["t_memory_s"] == pytest.approx(
            j["t_memory_s"] * JR.HBM_BW / TR.HBM_BW, rel=1e-12)
        assert r["t_collective_s"] == pytest.approx(
            j["t_collective_s"] * JR.LINK_BW / TR.LINK_BW, rel=1e-12)
    # bench_roofline: one row per cell's records
    full_table = TR.full_table
    monkeypatch.setattr(TR, "full_table", lambda: full_table(tmp_path))
    common.ROWS.clear()
    bench_roofline.run()
    assert len(common.ROWS) == 32
    assert all(row.startswith("roofline_") for row in common.ROWS)


def test_roofline_constants_are_the_h100s():
    from repro_torch.launch import roofline as TR

    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12, 50e9)


# ---------------------------------------------------------------------------
# the launcher's mesh flags
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launch_train_distributed_matches_plain(tmp_path, monkeypatch):
    """``--distributed`` on a gloo group of one rank: every leaf stays a
    plain tensor, so the losses are the run's without the flag, bit for
    bit."""
    import functools

    import torch.distributed as dist

    from repro_torch.launch import train

    # every step's loss in the report (the Trainer logs step 1, then
    # every 10th)
    monkeypatch.setattr(train, "TrainerConfig", functools.partial(
        train.TrainerConfig, log_every=1))
    argv = ["--arch", "recurrentgemma_2b", "--smoke", "--steps", "2",
            "--device", "cpu"]
    plain = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    for k, v in (("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", str(_free_port())), ("RANK", "0"),
                 ("WORLD_SIZE", "1")):
        monkeypatch.setenv(k, v)
    dist_run = train.main(argv + ["--distributed", "--ckpt-dir",
                                  str(tmp_path / "b")])
    assert not dist.is_initialized()  # the launcher left no group behind
    losses = lambda r: [m["loss"] for m in r["metrics"]]  # noqa: E731
    assert losses(dist_run) == losses(plain) and len(losses(plain)) == 2


def test_launch_train_refuses_a_world_above_one(tmp_path, monkeypatch):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import train

    monkeypatch.setattr(
        dist, "init_process_group",
        lambda *a, **kw: dist.distributed_c10d.init_process_group(
            "fake", store=FakeStore(), rank=0, world_size=2))
    with pytest.raises(NotImplementedError, match="C.21"):
        train.main(["--arch", "llama3_8b", "--smoke", "--steps", "1",
                    "--device", "cpu", "--distributed", "--ckpt-dir",
                    str(tmp_path)])
    assert not dist.is_initialized()


def test_run_cells_judges_a_failed_cell_on_its_exit_not_a_stale_record(
        tmp_path):
    """``dryrun.run_cells`` (what ``--held`` runs) removes a record an
    earlier run left before the cell starts: a cell whose process exits
    with another code than 0 is an error, not the old record."""
    from repro_torch.launch import dryrun

    name = dryrun.cell_name("xlstm_350m", "decode_32k", False, 1)
    stale = tmp_path / f"{name}.json"
    stale.write_text(json.dumps({"arch": "xlstm_350m", "cost": {}}))
    records, outputs = dryrun.run_cells(
        [name], tmp_path, module="repro_torch.launch.no_such_cli")
    assert records[name]["error"] == "exit 1"
    assert records[name]["exit"] == 1
    assert not stale.exists()
    assert "No module named" in outputs[name]


def test_run_cells_stops_a_cell_past_its_timeout(tmp_path):
    """A cell still running ``timeout`` seconds after the first started is
    killed and recorded as an error; a cell not yet started is too."""
    from repro_torch.launch import dryrun

    names = [dryrun.cell_name("xlstm_350m", "decode_32k", m, 1)
             for m in (False, True)]
    records, _ = dryrun.run_cells(names, tmp_path, jobs=1, timeout=0)
    for name in names:
        assert records[name] == {"error": "past 0 s", "exit": None}
        assert not (tmp_path / f"{name}.json").exists()
