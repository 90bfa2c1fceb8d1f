"""The port's task-graph construction and async executor against the
reference (``tests/test_graph.py``): dependency correctness,
serial-equivalence (bitwise outputs, identical copy counts), HEFT-lite
placement, and modeled-makespan wins on fork-join DAGs.

Every case of the reference's graph tests runs here on ``repro_torch``
with accelerator spaces on CPU tensors (``device="cpu"``).  Where a value
is computed, the JAX package computes it too and the two must be equal:
the DAG's edges, critical path and upward ranks for the same task list;
for the same workload, the serial run's ledger (per-pair counts and
bytes) and modeled makespan, and with two accelerators and no cpu PE the
graph run's as well (a cpu PE beside accelerators makes graph-mode
placement timing-dependent in both packages).
"""

import types

import numpy as np
import pytest
import torch

from repro.apps import radar as jradar
from repro.apps import synthetic as jsynthetic
from repro.core import graph as jgraph
from repro.core import hete as jhete
from repro.core import runtime as jruntime
from repro_torch.apps import radar as tradar
from repro_torch.apps import synthetic as tsynthetic
from repro_torch.apps.radar import build_2fzf, build_pd
from repro_torch.apps.synthetic import build_diamonds, build_fork_join
from repro_torch.core.graph import CostModel, build_graph
from repro_torch.core.hete import HeteContext, hete_sync
from repro_torch.core.runtime import Task

torch.set_num_threads(1)

#: the two packages' workload builders, side by side
T = types.SimpleNamespace(
    make_runtime=lambda **kw: tradar.make_runtime(device="cpu", **kw),
    build_2fzf=tradar.build_2fzf, build_3zip=tradar.build_3zip,
    build_fork_join=tsynthetic.build_fork_join, hete_sync=hete_sync)
J = types.SimpleNamespace(
    make_runtime=jradar.make_runtime,
    build_2fzf=jradar.build_2fzf, build_3zip=jradar.build_3zip,
    build_fork_join=jsynthetic.build_fork_join, hete_sync=jhete.hete_sync)


def make_runtime(**kw):
    """The port's radar runtime with accelerator spaces on CPU tensors."""
    return T.make_runtime(**kw)


def _jax_graph(tasks):
    """The JAX package's DAG for the same task list: every root buffer
    mirrored (same shape, dtype and fragmentation) in a JAX context."""
    jctx = jhete.HeteContext()
    roots = {}

    def mirror(hd):
        root = hd.root
        jr = roots.get(id(root))
        if jr is None:
            jr = roots[id(root)] = jctx.malloc(root.shape, root.dtype)
            if root.fragments is not None:
                jr.fragment(root.fragments[0].shape[0])
        if hd.parent is None:
            return jr
        return jr[next(i for i, f in enumerate(root.fragments) if f is hd)]

    return jgraph.build_graph([
        jruntime.Task(t.op, [mirror(h) for h in t.inputs],
                      [mirror(h) for h in t.outputs], name=t.name)
        for t in tasks])


def _graph(tasks):
    """``build_graph`` on the port, held equal to the JAX package's DAG
    (edges and critical path) for the same task list."""
    g = build_graph(tasks)
    jg = _jax_graph(tasks)
    assert g.edges() == jg.edges()
    assert g.critical_path_len == jg.critical_path_len
    return g


def _ledger(ctx):
    snap = ctx.ledger.snapshot()
    return snap["by_pair"], dict(ctx.ledger.bytes_moved)


# ---------------------------------------------------------------------------
# DAG construction
# ---------------------------------------------------------------------------


def _mk(ctx, n=16):
    return ctx.malloc((n,), np.complex64)


def test_raw_edges_linear_chain():
    ctx = HeteContext()
    a, b, c = _mk(ctx), _mk(ctx), _mk(ctx)
    g = _graph([
        Task("fft", [a], [b], name="t0"),
        Task("ifft", [b], [c], name="t1"),
    ])
    assert g.edges() == [(0, 1)]
    assert g.critical_path_len == 2


def test_raw_fork_and_join_edges():
    ctx = HeteContext()
    a, l, r, o = (_mk(ctx) for _ in range(4))
    g = _graph([
        Task("fft", [a], [l]),
        Task("fft", [a], [r]),
        Task("zip", [l, r], [o]),
    ])
    assert g.edges() == [(0, 2), (1, 2)]
    assert g.critical_path_len == 2
    assert len(g.roots()) == 2


def test_war_edge_on_overwrite():
    ctx = HeteContext()
    a, b, x = _mk(ctx), _mk(ctx), _mk(ctx)
    g = _graph([
        Task("zip", [a, b], [x], name="reader"),
        Task("fft", [a], [a], name="overwriter"),  # in-place: WAR on reader
    ])
    assert (0, 1) in g.edges()


def test_waw_edge_between_writers():
    ctx = HeteContext()
    a, x = _mk(ctx), _mk(ctx)
    g = _graph([
        Task("fft", [a], [x]),
        Task("ifft", [a], [x]),  # rewrites x: WAW
    ])
    assert (0, 1) in g.edges()


def test_fragments_alias_parent_but_not_siblings():
    ctx = HeteContext()
    parent = ctx.malloc((32,), np.complex64)
    parent.fragment(16)
    other = _mk(ctx, 16)
    tasks = [
        Task("fft", [other], [parent[0]], name="w_frag0"),
        Task("fft", [other], [parent[1]], name="w_frag1"),
        Task("fft", [parent], [other], name="r_parent"),  # reads whole parent
    ]
    g = _graph(tasks)
    edges = g.edges()
    assert (0, 2) in edges and (1, 2) in edges  # parent read sees both writes
    assert (0, 1) not in edges  # sibling fragments are independent


def test_parent_write_orders_before_fragment_read():
    ctx = HeteContext()
    parent = ctx.malloc((32,), np.complex64)
    parent.fragment(16)
    other = _mk(ctx, 32)
    o2 = _mk(ctx, 16)
    g = _graph([
        Task("fft", [other], [parent], name="w_parent"),
        Task("fft", [parent[1]], [o2], name="r_frag1"),
    ])
    assert (0, 1) in g.edges()


def test_independent_tasks_have_no_edges():
    ctx = HeteContext()
    bufs = [_mk(ctx) for _ in range(4)]
    g = _graph([
        Task("fft", [bufs[0]], [bufs[1]]),
        Task("fft", [bufs[2]], [bufs[3]]),
    ])
    assert g.n_edges == 0
    assert g.critical_path_len == 1


# ---------------------------------------------------------------------------
# Executor: serial equivalence (acceptance criterion)
# ---------------------------------------------------------------------------


def _run_both(build, *, policy, scheduler="round_robin", graph_kw=None,
              accelerators=("gpu0",), n_cpu=1):
    """Build the same workload twice; run serial and graph; return
    (out_serial, out_graph, snap_serial, snap_graph, rt_s, rt_g).

    ``build(P, ctx)`` builds through package ``P`` (:data:`T` or
    :data:`J`).  The JAX package runs the same serial case, and with no
    cpu PE the same graph case: ledgers (per-pair counts and bytes) and
    modeled makespans must be equal, outputs allclose."""
    runs = {}
    for key, P in (("T", T), ("J", J)):
        rt_s, ctx_s = P.make_runtime(policy=policy, scheduler=scheduler,
                                     n_cpu=n_cpu, accelerators=accelerators)
        bufs_s, tasks_s = build(P, ctx_s)
        rt_g, ctx_g = P.make_runtime(policy=policy, scheduler=scheduler,
                                     n_cpu=n_cpu, accelerators=accelerators)
        bufs_g, tasks_g = build(P, ctx_g)
        rt_s.run(tasks_s)
        rt_g.run_graph(tasks_g, **(graph_kw or {}))
        out_s = P.hete_sync(bufs_s["out"], context=ctx_s).copy()
        out_g = P.hete_sync(bufs_g["out"], context=ctx_g).copy()
        runs[key] = (out_s, out_g, ctx_s, ctx_g, rt_s, rt_g)
    out_s, out_g, ctx_s, ctx_g, rt_s, rt_g = runs["T"]
    jout_s, _, jctx_s, jctx_g, jrt_s, jrt_g = runs["J"]
    assert _ledger(ctx_s) == _ledger(jctx_s)
    assert rt_s.last_makespan_model == jrt_s.last_makespan_model
    if n_cpu == 0:
        assert _ledger(ctx_g) == _ledger(jctx_g)
        assert rt_g.last_makespan_model == jrt_g.last_makespan_model
    np.testing.assert_allclose(out_s, jout_s, rtol=1e-3,
                               atol=1e-3 * np.sqrt(out_s.size))
    return (out_s, out_g, ctx_s.ledger.snapshot(), ctx_g.ledger.snapshot(),
            rt_s, rt_g)


def test_run_graph_matches_serial_radar_rimms():
    """2FZF radar chain: bitwise-identical outputs + identical per-pair
    copy counts under rimms/round_robin."""
    out_s, out_g, snap_s, snap_g, *_ = _run_both(
        lambda P, c: P.build_2fzf(c, 256, seed=7), policy="rimms")
    assert np.array_equal(out_s, out_g)
    assert snap_s["by_pair"] == snap_g["by_pair"]
    assert snap_s["total_copies"] == snap_g["total_copies"]


def test_run_graph_matches_serial_forkjoin_rimms():
    """Synthetic fork-join DAG: bitwise outputs + identical copy counts."""
    out_s, out_g, snap_s, snap_g, *_ = _run_both(
        lambda P, c: P.build_fork_join(c, ways=4, n=1024, depth=2, seed=3),
        policy="rimms", n_cpu=0, accelerators=("gpu0", "gpu1"))
    assert np.array_equal(out_s, out_g)
    assert snap_s["by_pair"] == snap_g["by_pair"]


def test_run_graph_matches_serial_3zip():
    """3-stage ZIP pipeline (Fig 4c/8) ported to graph mode: the two leaf
    zips parallelize, the join zip orders after both; results and copy
    counts match serial."""
    out_s, out_g, snap_s, snap_g, rt_s, rt_g = _run_both(
        lambda P, c: P.build_3zip(c, 256, seed=11), policy="rimms",
        n_cpu=0, accelerators=("gpu0", "gpu1"))
    assert np.array_equal(out_s, out_g)
    assert snap_s["by_pair"] == snap_g["by_pair"]
    assert rt_g.last_report["critical_path"] == 2  # zip0/zip1 ∥ then zip2


def test_run_graph_matches_serial_reference_policy():
    out_s, out_g, snap_s, snap_g, *_ = _run_both(
        lambda P, c: P.build_2fzf(c, 128, seed=5), policy="reference")
    assert np.array_equal(out_s, out_g)
    assert snap_s["by_pair"] == snap_g["by_pair"]


def test_run_graph_fragmented_pd():
    """Pulse-Doppler with fragment() (§3.2.3) runs correctly in graph
    mode: every way's IFFT(FFT(a)*FFT(b)) matches numpy."""
    rt, ctx = make_runtime(policy="rimms", n_cpu=0,
                           accelerators=("gpu0", "gpu1"))
    points, tasks = build_pd(ctx, ways=4, n=64, use_fragment=True)
    rt.run_graph(tasks)
    for i in range(4):
        a = points["a"][1][i].data.copy()
        b = points["b"][1][i].data.copy()
        want = np.fft.ifft(np.fft.fft(a) * np.fft.fft(b)).astype(np.complex64)
        got = hete_sync(points["out"][1][i], context=ctx)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_run_graph_without_prefetch():
    out_s, out_g, snap_s, snap_g, *_ = _run_both(
        lambda P, c: P.build_2fzf(c, 128, seed=2), policy="rimms",
        graph_kw={"prefetch": False})
    assert np.array_equal(out_s, out_g)
    assert snap_s["by_pair"] == snap_g["by_pair"]


def test_run_graph_empty_task_list():
    rt, ctx = make_runtime(policy="rimms")
    assert rt.run_graph([]) == 0.0


def test_run_graph_propagates_kernel_errors():
    rt, ctx = make_runtime(policy="rimms", accelerators=("gpu0",))
    def boom(ins):
        raise RuntimeError("kernel exploded")
    rt.register_kernel("fft", "gpu", boom)
    rt.register_kernel("fft", "cpu", boom)
    a, b = ctx.malloc((8,), np.complex64), ctx.malloc((8,), np.complex64)
    with pytest.raises(RuntimeError, match="kernel exploded"):
        rt.run_graph([Task("fft", [a], [b])])


def test_run_graph_raises_on_bad_pin_of_dependent_task():
    """Regression: a scheduling error for a *non-root* task (raised while
    completing its dependency) must propagate, not hang the run."""
    rt, ctx = make_runtime(policy="rimms", scheduler="heft",
                           accelerators=("gpu0",))
    a, b, c = (_mk(ctx, 32) for _ in range(3))
    tasks = [
        Task("fft", [a], [b], name="ok"),
        Task("ifft", [b], [c], pin="no_such_pe", name="bad_pin"),
    ]
    with pytest.raises(KeyError):
        rt.run_graph(tasks)


def test_run_graph_halts_after_failure():
    """After a task fails, tasks already queued behind it on the same PE
    must not execute (and the error must reach the caller)."""
    rt, ctx = make_runtime(policy="rimms", n_cpu=0, accelerators=("gpu0",))
    def boom(ins):
        raise RuntimeError("boom")
    rt.register_kernel("fft", "gpu", boom)
    bufs = [_mk(ctx, 32) for _ in range(6)]
    tasks = [Task("fft", [bufs[0]], [bufs[1]], pin="gpu0", name="dies")] + [
        Task("zip", [bufs[i], bufs[i]], [bufs[i + 1]], pin="gpu0",
             name=f"queued{i}")
        for i in range(2, 5)
    ]
    with pytest.raises(RuntimeError, match="boom"):
        rt.run_graph(tasks)
    assert rt.task_log == []  # nothing committed after the failure


# ---------------------------------------------------------------------------
# Scheduling: HEFT-lite + makespan
# ---------------------------------------------------------------------------


def test_heft_serial_and_graph_produce_correct_results():
    for mode in ("serial", "graph"):
        rt, ctx = make_runtime(policy="rimms", scheduler="heft",
                               n_cpu=1, accelerators=("gpu0", "gpu1"))
        bufs, tasks = build_2fzf(ctx, 128, seed=9)
        (rt.run if mode == "serial" else rt.run_graph)(tasks)
        want = np.fft.ifft(
            np.fft.fft(bufs["a"].data) * np.fft.fft(bufs["b"].data)
        ).astype(np.complex64)
        np.testing.assert_allclose(
            hete_sync(bufs["out"], context=ctx), want, atol=1e-4)


def test_heft_graph_uses_multiple_pes_on_wide_dag():
    rt, ctx = make_runtime(policy="rimms", scheduler="heft",
                           n_cpu=0, accelerators=("gpu0", "gpu1"))
    _, tasks = build_diamonds(ctx, count=8, n=1024)
    rt.run_graph(tasks)
    used = {pe for _, pe in rt.task_log}
    assert used == {"gpu0", "gpu1"}


def test_graph_modeled_makespan_beats_serial_on_forkjoin():
    """Acceptance: lower modeled makespan than serial dispatch on a
    ≥2-accelerator fork-join workload."""
    def build(ctx):
        return build_fork_join(ctx, ways=4, n=4096, depth=2, seed=1)
    rt_s, ctx_s = make_runtime(policy="rimms", n_cpu=0,
                               accelerators=("gpu0", "gpu1"))
    bufs, tasks = build(ctx_s)
    rt_s.run(tasks)
    rt_g, ctx_g = make_runtime(policy="rimms", n_cpu=0,
                               accelerators=("gpu0", "gpu1"))
    bufs_g, tasks_g = build(ctx_g)
    rt_g.run_graph(tasks_g)
    assert rt_g.last_makespan_model < rt_s.last_makespan_model
    for mode, rt in (("serial", rt_s), ("graph", rt_g)):
        jrt, jctx = J.make_runtime(policy="rimms", n_cpu=0,
                                   accelerators=("gpu0", "gpu1"))
        _, jtasks = J.build_fork_join(jctx, ways=4, n=4096, depth=2, seed=1)
        (jrt.run if mode == "serial" else jrt.run_graph)(jtasks)
        assert rt.last_makespan_model == jrt.last_makespan_model
    # and the executor's report carries the schedule evidence
    rep = rt_g.last_report
    assert rep["n_tasks"] == len(tasks_g)
    assert rep["critical_path"] < rep["n_tasks"]
    assert len(rep["timeline"]) == len(tasks_g)


def test_timeline_gantt_renders():
    rt, ctx = make_runtime(policy="rimms", n_cpu=0,
                           accelerators=("gpu0", "gpu1"))
    _, tasks = build_fork_join(ctx, ways=2, n=512, depth=1)
    rt.run_graph(tasks)
    txt = rt.timeline.gantt(40)
    assert "gpu0" in txt and "gpu1" in txt and "#" in txt


def test_cost_model_learns_from_observations():
    cm = CostModel()
    prior = cm.estimate("fft", "acc", 1 << 20)
    cm.observe("fft", "acc", 1 << 20, 0.5)  # much slower than prior
    assert cm.estimate("fft", "acc", 1 << 20) > prior
    assert cm.prior_estimate("fft", "acc", 1 << 20) == pytest.approx(prior)
    jcm = jgraph.CostModel()
    assert prior == jcm.estimate("fft", "acc", 1 << 20)
    jcm.observe("fft", "acc", 1 << 20, 0.5)
    assert cm.estimate("fft", "acc", 1 << 20) == jcm.estimate(
        "fft", "acc", 1 << 20)


def test_upward_ranks_decrease_along_chain():
    ctx = HeteContext()
    a, b, c, d = (_mk(ctx) for _ in range(4))
    tasks = [
        Task("fft", [a], [b]),
        Task("fft", [b], [c]),
        Task("fft", [c], [d]),
    ]
    g = _graph(tasks)
    g.compute_ranks(lambda t: 1.0, lambda t: 0.1)
    ranks = [n.rank for n in g.nodes]
    assert ranks[0] > ranks[1] > ranks[2]
    jg = _jax_graph(tasks)
    jg.compute_ranks(lambda t: 1.0, lambda t: 0.1)
    assert ranks == [n.rank for n in jg.nodes]
