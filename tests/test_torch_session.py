"""The port's streaming session API against the reference
(``tests/test_session.py``): op registry, incremental DAG, buffer
futures, concurrent submitters, exception propagation, lifecycle, and
bit-identical equivalence with batch run_graph.

Every case of the reference's session tests runs here on ``repro_torch``
with accelerator spaces on CPU tensors (``device="cpu"``).  Where a value
is computed, the JAX package computes it too and the two must be equal:
the incremental DAG's edges for the same submissions, a fork-join
stream's ledger (per-pair counts and bytes) and replayed modeled
makespan, and the batch runs' placements.
"""

import threading

import numpy as np
import pytest
import torch

from repro.apps import radar as jradar
from repro.apps import synthetic as jsynthetic
from repro.core import graph as jgraph
from repro_torch.apps import radar as tradar
from repro_torch.apps.radar import submit_2fzf
from repro_torch.apps.synthetic import build_fork_join, submit_fork_join
from repro_torch.core import api as rimms
from repro_torch.core.graph import GraphBuilder, build_graph
from repro_torch.core.hete import AllocError, HeteContext, hete_sync
from repro_torch.core.runtime import Task

torch.set_num_threads(1)


def make_runtime(**kw):
    """The port's radar runtime with accelerator spaces on CPU tensors."""
    return tradar.make_runtime(device="cpu", **kw)


def make_session(**kw):
    """The port's radar session with accelerator spaces on CPU tensors."""
    return tradar.make_session(device="cpu", **kw)


def emulated(*args, **kw):
    """``Session.emulated`` with accelerator spaces on CPU tensors."""
    return rimms.Session.emulated(*args, device="cpu", **kw)


def _jax_fork_join_stream(result=False, **kw):
    """The JAX package's streamed fork-join on two accelerators under
    round robin (with ``result``, the output read back as the port's
    case reads it): (per-pair counts, per-pair bytes, replayed
    makespan)."""
    with jradar.make_session(scheduler="round_robin", n_cpu=0,
                             accelerators=("gpu0", "gpu1")) as s:
        futs = jsynthetic.submit_fork_join(s, **kw)
        if result:
            futs["out"].result()
        s.barrier()
        return (s.ledger.snapshot()["by_pair"], dict(s.ledger.bytes_moved),
                s.report()["makespan_model"])


# ---------------------------------------------------------------------------
# op registry
# ---------------------------------------------------------------------------


def test_op_decorator_registers_per_kind_variants():
    reg = rimms.OpRegistry()

    @rimms.op("scale", kinds=("cpu", "gpu"), registry=reg)
    def scale(ins, *, k=2.0):
        return ins[0] * k

    assert reg.kinds("scale") == ["cpu", "gpu"]
    assert reg.get("scale", "cpu") is scale
    assert reg.ops() == ["scale"]
    # the function stays directly callable
    np.testing.assert_allclose(scale([np.ones(4)], k=3.0), 3.0)


def test_op_double_registration_rejected_unless_replace():
    reg = rimms.OpRegistry()

    @rimms.op("f", kinds=("cpu",), registry=reg)
    def f1(ins):
        return ins[0]

    with pytest.raises(ValueError, match="already registered"):
        @rimms.op("f", kinds=("cpu",), registry=reg)
        def f2(ins):
            return ins[0]

    @rimms.op("f", kinds=("cpu",), registry=reg, replace=True)
    def f3(ins):
        return ins[0]

    assert reg.get("f", "cpu") is f3


def test_registry_install_missing_only_keeps_manual_kernels():
    rt, _ = make_runtime(policy="rimms", accelerators=("gpu0",))
    sentinel = lambda ins: ins[0]
    rt.register_kernel("fft", "cpu", sentinel)
    rimms.default_registry.install(rt, missing_only=True)
    assert rt._kernels[("fft", "cpu")] is sentinel


def test_session_runs_custom_op_on_general_purpose_pes():
    """A custom @op variant is usable through a session without touching
    make_emulated_soc's op lists: install extends general-purpose PE
    kinds' supports."""
    reg = rimms.OpRegistry()

    @rimms.op("triple", kinds=("cpu",), registry=reg)
    def triple(ins):
        return ins[0] * 3

    with emulated(accelerators=(), n_cpu=1,
                                scheduler="round_robin",
                                registry=reg) as s:
        x = s.malloc((8,), np.float32)
        x.data[:] = 2.0
        y = s.submit("triple", [x])
        np.testing.assert_allclose(y.result(), 6.0)


# ---------------------------------------------------------------------------
# incremental DAG builder
# ---------------------------------------------------------------------------


def _mk(ctx, n=16):
    return ctx.malloc((n,), np.complex64)


def test_graph_builder_matches_batch_build_graph():
    """Incremental add() produces exactly the DAG batch build_graph
    does (same edge set) on a fork-join with fragments."""
    ctx = HeteContext()
    parent = ctx.malloc((32,), np.complex64)
    parent.fragment(16)
    a, l, r, o = (_mk(ctx) for _ in range(4))
    tasks = [
        Task("fft", [a], [l]),
        Task("fft", [a], [r]),
        Task("zip", [l, r], [o]),
        Task("fft", [o], [parent[0]]),
        Task("fft", [o], [parent[1]]),
        Task("fft", [parent], [a]),  # reads both fragments, WAR on t0/t1
    ]
    batch = build_graph(tasks)
    builder = GraphBuilder()
    for t in tasks:
        builder.add(t)
    incremental = builder.graph()
    assert batch.edges() == incremental.edges()
    assert batch.critical_path_len == incremental.critical_path_len
    # the JAX package's builder on the same submissions: the same DAG
    from repro.core import hete as jhete
    from repro.core.runtime import Task as JTask

    jctx = jhete.HeteContext()
    jparent = jctx.malloc((32,), np.complex64)
    jparent.fragment(16)
    ja, jl, jr, jo = (jctx.malloc((16,), np.complex64) for _ in range(4))
    jbuilder = jgraph.GraphBuilder()
    for t in [JTask("fft", [ja], [jl]), JTask("fft", [ja], [jr]),
              JTask("zip", [jl, jr], [jo]), JTask("fft", [jo], [jparent[0]]),
              JTask("fft", [jo], [jparent[1]]),
              JTask("fft", [jparent], [ja])]:
        jbuilder.add(t)
    assert incremental.edges() == jbuilder.graph().edges()


def test_graph_builder_tracks_versions_and_last_writer():
    ctx = HeteContext()
    a, b = _mk(ctx), _mk(ctx)
    builder = GraphBuilder()
    assert builder.version_of(b) == 0
    assert builder.last_writer(b) is None
    builder.add(Task("fft", [a], [b]))
    assert builder.version_of(b) == 1
    assert builder.last_writer(b) == 0
    builder.add(Task("ifft", [a], [b]))  # rewrite bumps the version
    assert builder.version_of(b) == 2
    assert builder.last_writer(b) == 1
    # fragments version their parent root
    parent = ctx.malloc((32,), np.complex64)
    parent.fragment(16)
    builder.add(Task("fft", [a], [parent[1]]))
    assert builder.version_of(parent) == 1
    assert builder.last_writer(parent[0]) == 2


# ---------------------------------------------------------------------------
# session: correctness + equivalence with batch modes (acceptance)
# ---------------------------------------------------------------------------


def test_session_radar_chain_matches_numpy():
    with make_session(accelerators=("gpu0", "gpu1")) as s:
        bufs = submit_2fzf(s, 256, seed=7)
        want = np.fft.ifft(
            np.fft.fft(bufs["a"].data) * np.fft.fft(bufs["b"].data)
        ).astype(np.complex64)
        np.testing.assert_allclose(bufs["out"].result(), want, atol=1e-4)


def test_session_bit_identical_to_run_graph_on_forkjoin():
    """Acceptance: the streaming session path produces bit-identical
    outputs and per-pair copy counts to batch run_graph under the rimms
    policy + static round_robin placement on the radar fork-join."""
    kw = dict(ways=4, n=1024, depth=2, seed=3)
    s = make_session(policy="rimms", scheduler="round_robin",
                     n_cpu=0, accelerators=("gpu0", "gpu1"))
    futs = submit_fork_join(s, **kw)
    out_stream = futs["out"].result().copy()
    s.barrier()
    snap_stream = s.ledger.snapshot()
    s.close()

    rt, ctx = make_runtime(policy="rimms", scheduler="round_robin",
                           n_cpu=0, accelerators=("gpu0", "gpu1"))
    bufs, tasks = build_fork_join(ctx, **kw)
    rt.run_graph(tasks)
    out_batch = hete_sync(bufs["out"], context=ctx).copy()
    snap_batch = ctx.ledger.snapshot()

    assert np.array_equal(out_stream, out_batch)
    assert snap_stream["by_pair"] == snap_batch["by_pair"]
    assert snap_stream["total_copies"] == snap_batch["total_copies"]
    jpairs, jbytes, _ = _jax_fork_join_stream(result=True, **kw)
    assert snap_stream["by_pair"] == jpairs
    assert dict(s.ledger.bytes_moved) == jbytes


def test_session_heft_windowed_placement_correct_and_multi_pe():
    with make_session(scheduler="heft", n_cpu=0,
                      accelerators=("gpu0", "gpu1")) as s:
        futs = submit_fork_join(s, ways=4, n=2048, depth=2, seed=1)
        out = futs["out"].result()
        assert np.all(np.isfinite(out))
        s.barrier()
        rep = s.report()
    assert rep["n_tasks"] == rep["n_completed"]
    used = {pe for _, pe in s.runtime.task_log}
    assert used == {"gpu0", "gpu1"}
    assert rep["makespan_model"] > 0


def test_session_report_replay_is_deterministic():
    """Same submissions → exactly the same replayed modeled makespan,
    run to run (the bench_stream gate depends on this)."""
    makespans = []
    for _ in range(2):
        with make_session(scheduler="round_robin", n_cpu=0,
                          accelerators=("gpu0", "gpu1")) as s:
            submit_fork_join(s, ways=4, n=1024, depth=2, seed=5)
            s.barrier()
            makespans.append(s.report()["makespan_model"])
    assert makespans[0] == makespans[1]
    assert makespans[0] == _jax_fork_join_stream(
        ways=4, n=1024, depth=2, seed=5)[2]


# ---------------------------------------------------------------------------
# session: concurrency + out-of-order completion
# ---------------------------------------------------------------------------


def test_concurrent_submitter_threads():
    """Multi-tenant streaming: N client threads submit radar chains
    against ONE session; every client's output matches numpy."""
    s = make_session(scheduler="round_robin", n_cpu=0,
                     accelerators=("gpu0", "gpu1"))
    results, errors = {}, []

    def client(i):
        try:
            bufs = submit_2fzf(s, 128, seed=i, tag=f"_c{i}",
                               pins=(f"gpu{i % 2}",) * 4)
            got = bufs["out"].result(timeout=60)
            want = np.fft.ifft(
                np.fft.fft(bufs["a"].data) * np.fft.fft(bufs["b"].data)
            ).astype(np.complex64)
            results[i] = (got, want)
        except BaseException as e:  # pragma: no cover - diagnostic
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(results) == 8
    for got, want in results.values():
        np.testing.assert_allclose(got, want, atol=1e-4)
    s.barrier()
    assert s.report()["n_completed"] == 8 * 4
    s.close()


def test_out_of_order_completion_and_result():
    """A short independent chain completes (and resolves) while a long
    chain is still streaming; waiting on futures in reverse submission
    order works."""
    with make_session(scheduler="round_robin", n_cpu=0,
                      accelerators=("gpu0", "gpu1")) as s:
        long = submit_fork_join(s, ways=8, n=4096, depth=3, seed=2)
        short = submit_2fzf(s, 64, seed=9, tag="_s")
        short_out = short["out"].result(timeout=60)  # before the long chain
        long_out = long["out"].result(timeout=120)
        want = np.fft.ifft(
            np.fft.fft(short["a"].data) * np.fft.fft(short["b"].data)
        ).astype(np.complex64)
        np.testing.assert_allclose(short_out, want, atol=1e-4)
        assert np.all(np.isfinite(long_out))


def test_resubmitted_buffer_result_waits_for_latest_writer():
    """result() synchronizes the buffer: after resubmitting the same
    buffer as an output, it resolves to the newest submitted content."""
    with make_session(accelerators=("gpu0",), n_cpu=0,
                      scheduler="round_robin") as s:
        x = s.malloc((64,), np.complex64)
        x.data[:] = 1.0
        f1 = s.submit("fft", [x])
        f2 = s.submit("ifft", [f1], out=f1)  # overwrite f1's buffer
        np.testing.assert_allclose(f2.result(), x.data, atol=1e-4)
        assert f1.version == 1 and f2.version == 2
        # f1's handle now resolves to the rewritten (latest) bytes too
        np.testing.assert_allclose(f1.result(), x.data, atol=1e-4)


# ---------------------------------------------------------------------------
# session: exception propagation
# ---------------------------------------------------------------------------


def _boom_registry():
    reg = rimms.OpRegistry()

    @rimms.op("good", kinds=("cpu",), registry=reg)
    def good(ins):
        return ins[0] * 2

    @rimms.op("boom", kinds=("cpu",), registry=reg)
    def boom(ins):
        raise RuntimeError("kernel exploded")

    return reg


def test_exception_propagates_through_future_result():
    with emulated(accelerators=(), n_cpu=1,
                                scheduler="round_robin",
                                registry=_boom_registry()) as s:
        x = s.malloc((8,), np.float32)
        y = s.submit("boom", [x])
        with pytest.raises(RuntimeError, match="kernel exploded"):
            y.result(timeout=30)
        assert isinstance(y.exception(), RuntimeError)
        # observed via result(): the exiting barrier must not re-raise


def test_failure_fails_dependent_subtree_but_not_independent_chains():
    s = emulated(accelerators=(), n_cpu=1,
                               scheduler="round_robin",
                               registry=_boom_registry())
    x = s.malloc((8,), np.float32)
    x.data[:] = 1.0
    bad = s.submit("boom", [x])
    dependent = s.submit("good", [bad])
    independent = s.submit("good", [x])
    with pytest.raises(RuntimeError, match="kernel exploded"):
        dependent.result(timeout=30)
    np.testing.assert_allclose(independent.result(timeout=30), 2.0)
    # both failures observed through results → barrier is clean
    s.barrier()
    # the stream keeps flowing after a failure
    again = s.submit("good", [independent])
    np.testing.assert_allclose(again.result(timeout=30), 4.0)
    s.close()


def test_deep_dependent_chain_fails_without_recursion_blowup():
    """A failure at the head of a deeper-than-recursion-limit admitted
    chain must cascade iteratively: every dependent fails, the barrier
    raises (once), and the worker thread survives."""
    import sys

    depth = sys.getrecursionlimit() + 200
    s = emulated(accelerators=(), n_cpu=1,
                               scheduler="round_robin",
                               registry=_boom_registry())
    x = s.malloc((4,), np.float32)
    cur = s.submit("boom", [x])
    for _ in range(depth):
        cur = s.submit("good", [cur])
    with pytest.raises(RuntimeError, match="kernel exploded"):
        cur.result(timeout=60)
    s.barrier()  # cascade observed through the tail future
    rep = s.report()
    assert rep["n_failed"] == depth + 1
    # the stream (and its PE worker) is still alive after the cascade
    ok = s.submit("good", [x])
    assert ok.result(timeout=30) is not None
    s.close()


def test_scalar_output_shape_is_respected():
    """out_shape=() (a 0-d scalar buffer) must not be discarded as
    falsy in favour of the input's shape."""
    reg = rimms.OpRegistry()

    @rimms.op("total", kinds=("cpu",), registry=reg)
    def total(ins):
        return np.float32(ins[0].sum())

    with emulated(accelerators=(), n_cpu=1,
                                scheduler="round_robin",
                                registry=reg) as s:
        x = s.malloc((8,), np.float32)
        x.data[:] = 2.0
        f = s.submit("total", [x], out_shape=(), out_dtype=np.float32)
        assert f.shape == ()
        np.testing.assert_allclose(f.result(timeout=30), 16.0)


def test_barrier_raises_unobserved_failure_once():
    s = emulated(accelerators=(), n_cpu=1,
                               scheduler="round_robin",
                               registry=_boom_registry())
    x = s.malloc((8,), np.float32)
    s.submit("boom", [x])
    with pytest.raises(RuntimeError, match="kernel exploded"):
        s.barrier()
    s.barrier()  # observed now: second barrier is clean
    s.close()


def test_bad_pin_fails_future_not_submitter():
    with emulated(accelerators=("gpu0",),
                                scheduler="round_robin") as s:
        x = s.malloc((8,), np.complex64)
        y = s.submit("fft", [x], pin="no_such_pe")
        with pytest.raises(KeyError):
            y.result(timeout=30)


def test_unknown_op_fails_future():
    with emulated(accelerators=("gpu0",),
                                scheduler="heft") as s:
        x = s.malloc((8,), np.complex64)
        y = s.submit("no_such_op", [x])
        with pytest.raises(LookupError):
            y.result(timeout=30)


# ---------------------------------------------------------------------------
# session: buffer lifecycle (free-after-last-use)
# ---------------------------------------------------------------------------


def test_free_after_last_use_defers_until_stream_drains():
    with make_session(accelerators=("gpu0",), n_cpu=0,
                      scheduler="round_robin") as s:
        x = s.malloc((1 << 16,), np.complex64)
        x.data[:] = 1.0
        y = s.submit("fft", [x])
        freed_now = x.free()  # may still be read by the in-flight fft
        out = y.result(timeout=60)
        s.barrier()
        assert x.hete.freed  # released after its last reader completed
        assert np.all(np.isfinite(out))
        assert not freed_now or x.hete.freed


def test_free_idle_buffer_is_immediate_and_double_free_raises():
    with make_session(accelerators=("gpu0",)) as s:
        x = s.malloc((64,), np.complex64)
        assert s.free(x) is True
        assert x.hete.freed
        with pytest.raises(AllocError, match="double hete_free"):
            s.free(x)


def test_submit_after_close_raises():
    s = make_session(accelerators=("gpu0",))
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.malloc((8,))
    with pytest.raises(RuntimeError, match="closed"):
        s.submit("fft", [np.zeros(8, np.complex64)])


def test_numpy_inputs_are_adopted():
    with make_session(accelerators=("gpu0",), n_cpu=0,
                      scheduler="round_robin") as s:
        sig = (np.arange(64) % 7).astype(np.complex64)
        f = s.submit("fft", [sig])
        np.testing.assert_allclose(
            f.result(timeout=30), np.fft.fft(sig).astype(np.complex64),
            atol=1e-4)


# ---------------------------------------------------------------------------
# runtime stats hygiene
# ---------------------------------------------------------------------------


def test_run_resets_task_log_and_rr_state_each_run():
    """Cross-run state leaks fixed: task_log holds exactly the last
    run's placements and round-robin rotation restarts, so identical
    task lists place identically on every run."""
    from repro_torch.apps.radar import build_2fzf

    rt, ctx = make_runtime(policy="rimms", n_cpu=0,
                           accelerators=("gpu0", "gpu1"))
    bufs, tasks = build_2fzf(ctx, 128, seed=1)
    rt.run(tasks)
    first = list(rt.task_log)
    assert len(first) == len(tasks)
    rt.run(tasks)
    assert rt.task_log == first  # same placements, not accumulated
    assert rt._rr_state != {} and len(rt.task_log) == len(tasks)
    rt.run_graph(tasks)
    assert len(rt.task_log) == len(tasks)
    jrt, jctx = jradar.make_runtime(policy="rimms", n_cpu=0,
                                    accelerators=("gpu0", "gpu1"))
    jrt.run(jradar.build_2fzf(jctx, 128, seed=1)[1])
    assert first == jrt.task_log
    rt.reset_stats()
    assert rt.task_log == [] and rt._rr_state == {}
    assert rt.last_report is None and rt.last_makespan_model == 0.0
