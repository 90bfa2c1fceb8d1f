"""The port's capacity-pressure subsystem against the reference
(``tests/test_pressure.py``): transparent eviction, spill-to-host
write-back, pin/protect semantics, spill counters, and the executor's
persistent worker pool + capacity-aware prefetch.

Every case of the reference's pressure tests runs here on ``repro_torch``
over the port's device spaces (CPU tensors, ``device="cpu"``).  Where a
value is computed, the JAX package runs the same sequence and the two
must be equal: ledger snapshots (copies, bytes, per-pair counts,
evictions, write-back bytes, spill stalls), and for the radar pipeline
under pressure the serial run's ledger and modeled makespan.
"""

import types

import numpy as np
import pytest
import torch

from repro.core import hete as jhete
from repro.core import locations as jlocations
from repro_torch.core.allocator import AllocError
from repro_torch.core.hete import (
    HeteContext, MemorySpace, hete_sync, tensor_egress, tensor_ingest,
)
from repro_torch.core.locations import HOST, Location

torch.set_num_threads(1)

ACC = Location("device", "acc0")

#: each package's context, space and location types, side by side
T = types.SimpleNamespace(
    HeteContext=HeteContext, MemorySpace=MemorySpace, ACC=ACC,
    ingest=tensor_ingest("cpu"), egress=tensor_egress)
J = types.SimpleNamespace(
    HeteContext=jhete.HeteContext, MemorySpace=jhete.MemorySpace,
    ACC=jlocations.Location("device", "acc0"),
    ingest=lambda a: a.copy(), egress=lambda a: np.asarray(a))


def make_ctx(capacity=4096, tracking="flag", allocator="nextfit", P=T):
    ctx = P.HeteContext(tracking=tracking)
    ctx.register_space(P.MemorySpace(
        P.ACC, capacity=capacity, allocator=allocator,
        ingest=P.ingest, egress=P.egress,
    ))
    return ctx


def _both(scenario, **kw):
    """Run ``scenario(P, ctx)`` on the port and on the JAX package; the
    ledger snapshots and per-pair bytes must be equal.  Returns the
    port's context and the scenario's result."""
    out = {}
    for key, P in (("T", T), ("J", J)):
        ctx = make_ctx(P=P, **kw)
        out[key] = ctx, scenario(P, ctx)
    tctx, jctx = out["T"][0], out["J"][0]
    assert tctx.ledger.snapshot() == jctx.ledger.snapshot()
    assert dict(tctx.ledger.bytes_moved) == dict(jctx.ledger.bytes_moved)
    return out["T"]


# ---------------------------------------------------------------------------
# eviction engine
# ---------------------------------------------------------------------------


def test_pinned_exhaustion_raises_allocerror():
    """Eviction retries until only pinned bytes remain, then surfaces a
    genuine AllocError naming the pinned working set."""
    ctx = make_ctx(capacity=4096)
    a = ctx.malloc((2048,), np.uint8)
    b = ctx.malloc((2048,), np.uint8)
    ctx.ensure(a, ACC)
    ctx.ensure(b, ACC)
    c = ctx.malloc((2048,), np.uint8)
    with a.pinned(ACC), b.pinned(ACC):
        with pytest.raises(AllocError, match="pinned"):
            ctx.ensure(c, ACC)
    ctx.ensure(c, ACC)  # pins released → one victim spills, c fits
    assert ctx.ledger.total_evictions == 1


def test_unpin_without_pin_raises():
    ctx = make_ctx()
    hd = ctx.malloc((16,), np.uint8)
    with pytest.raises(ValueError):
        ctx.unpin(hd, ACC)


def test_clean_eviction_copies_nothing():
    """A clean replica (flag at host) is dropped without any write-back
    copy; only the re-ensure pays a host→device transfer."""
    def scenario(P, ctx):
        a = ctx.malloc((4096,), np.uint8)
        a.data[:] = 7
        ctx.ensure(a, P.ACC)  # 1 copy host→acc; flag stays HOST (read)
        assert ctx.ledger.total_copies == 1
        b = ctx.malloc((4096,), np.uint8)
        ctx.ensure(b, P.ACC)  # evicts a (clean): no write-back copy

    ctx, _ = _both(scenario, capacity=4096)
    snap = ctx.ledger.snapshot()
    assert snap["total_evictions"] == 1
    assert snap["writeback_bytes"] == 0
    assert snap["total_copies"] == 2  # just the two host→acc stagings
    assert snap["spill_stall_s"] == 0.0


def test_dirty_eviction_writes_back_and_roundtrips():
    """Evicted-then-re-ensured buffer round-trips bit-identically, and
    the ledger shows exactly the expected copies: host→acc staging,
    acc→host write-back, host→acc re-fetch."""
    ctx = make_ctx(capacity=4096)
    rng = np.random.default_rng(0)
    a = ctx.malloc((4096,), np.uint8)
    a.data[:] = rng.integers(0, 255, 4096, dtype=np.uint8)
    v = ctx.ensure(a, ACC)
    payload = (np.asarray(v) ^ 0xFF).astype(np.uint8)
    # device owns the only valid copy (a tensor, as a port kernel writes)
    ctx.mark_written(a, ACC, torch.from_numpy(payload))
    assert ctx.ledger.total_copies == 1

    b = ctx.malloc((4096,), np.uint8)
    ctx.ensure(b, ACC)  # forces eviction of dirty a → write-back
    snap = ctx.ledger.snapshot()
    assert snap["total_evictions"] == 1
    assert snap["writeback_bytes"] == 4096
    assert snap["by_pair"]["device:acc0->host:cpu"] == 1
    assert snap["spill_stall_s"] > 0.0
    assert a.last_location == HOST and ACC not in a.copies

    ctx.free(b)
    back = ctx.ensure(a, ACC)  # re-ensure: host→acc re-fetch
    np.testing.assert_array_equal(np.asarray(back), payload)
    np.testing.assert_array_equal(a.data, payload)
    assert ctx.ledger.snapshot()["by_pair"]["host:cpu->device:acc0"] == 3


def test_dirty_fragment_writeback_keeps_parent_coherent():
    """Evicting a parent whose *fragments* were written on the device
    must gather through the zero-copy host views: parent bytes coherent,
    fragment aliasing preserved."""
    ctx = make_ctx(capacity=4096)
    parent = ctx.malloc((1024,), np.float32)  # 4096 B
    parent.data[:] = 1.0
    frags = parent.fragment(256)
    v0 = ctx.ensure(frags[0], ACC)
    ctx.mark_written(frags[0], ACC, v0 * 5.0)
    v2 = ctx.ensure(frags[2], ACC)
    ctx.mark_written(frags[2], ACC, v2 * 9.0)

    other = ctx.malloc((1024,), np.float32)
    ctx.ensure(other, ACC)  # evicts parent: per-fragment write-back
    snap = ctx.ledger.snapshot()
    assert snap["total_evictions"] == 1
    assert snap["writeback_bytes"] == 2 * 256 * 4  # only dirty fragments

    # parent host bytes coherent, views still aliased
    np.testing.assert_allclose(parent.data[:256], 5.0)
    np.testing.assert_allclose(parent.data[256:512], 1.0)
    np.testing.assert_allclose(parent.data[512:768], 9.0)
    for f in frags:
        assert f.last_location == HOST and ACC not in f.copies
    np.testing.assert_allclose(hete_sync(frags[2], context=ctx), 9.0)
    # fragment views still write through to the parent
    frags[1].data[:] = 3.0
    np.testing.assert_allclose(parent.data[256:512], 3.0)


def test_lru_victim_order_with_access_clock():
    """Least-recently-touched resident is evicted first; a flag-hit read
    counts as a touch."""
    def scenario(P, ctx):
        a = ctx.malloc((4096,), np.uint8)
        b = ctx.malloc((4096,), np.uint8)
        ctx.ensure(a, P.ACC)
        ctx.ensure(b, P.ACC)
        # touch a *after* b so b becomes the LRU victim
        ctx.mark_written(a, P.ACC, P.ingest(np.ones((4096,), np.uint8)))
        ctx.ensure(a, P.ACC)  # flag hit → access-clock touch
        c = ctx.malloc((4096,), np.uint8)
        ctx.ensure(c, P.ACC)
        return a, b

    ctx, (a, b) = _both(scenario, capacity=8192)
    assert ACC not in b.copies      # b evicted
    assert ACC in a.copies          # a survived (recently touched)
    assert ctx.ledger.snapshot()["writeback_bytes"] == 0  # b was clean


def test_explicit_evict_api():
    ctx = make_ctx(capacity=8192)
    a = ctx.malloc((4096,), np.uint8)
    ctx.ensure(a, ACC)
    assert ctx.evict(a, ACC) is True
    assert ctx.evict(a, ACC) is False  # not resident any more
    arena = ctx.spaces[ACC].arena
    assert arena.used_bytes == 0
    with a.pinned(ACC):
        ctx.ensure(a, ACC)
        assert ctx.evict(a, ACC) is False  # pinned


def test_eviction_under_cached_tracking_drops_replica():
    ctx = make_ctx(capacity=4096, tracking="cached")
    a = ctx.malloc((4096,), np.uint8)
    a.data[:] = 3
    ctx.ensure(a, ACC)
    b = ctx.malloc((4096,), np.uint8)
    ctx.ensure(b, ACC)  # evicts a's replica
    assert ACC not in a.valid_at
    v = ctx.ensure(a, ACC)  # must re-copy, not serve the dropped replica
    np.testing.assert_array_equal(np.asarray(v), a.data)


def test_clean_eviction_does_not_revalidate_stale_host_copy():
    """Regression: evicting a clean replica while a *third* location owns
    the flag must not add HOST to valid_at — the host bytes are stale."""
    ACC2 = Location("device", "acc1")
    ctx = make_ctx(capacity=4096, tracking="cached")
    ctx.register_space(MemorySpace(
        ACC2, capacity=1 << 20, allocator="nextfit",
        ingest=tensor_ingest("cpu"), egress=tensor_egress,
    ))
    a = ctx.malloc((4096,), np.uint8)
    ctx.ensure(a, ACC)  # clean replica on ACC
    ctx.mark_written(a, ACC2, torch.full((4096,), 9, dtype=torch.uint8))  # ACC2 owns
    ctx.ensure(a, ACC)  # re-replicate on ACC (cached keeps both)
    b = ctx.malloc((4096,), np.uint8)
    ctx.ensure(b, ACC)  # evicts a's CLEAN ACC replica (flag on ACC2)
    assert HOST not in a.valid_at  # host still stale, not revalidated
    np.testing.assert_array_equal(ctx.sync(a), 9)  # pulls from ACC2


def test_protected_bytes_deferred_under_prefetch_guard():
    """Inside prefetch_guard, protected (queued-reader) bytes are not
    evictable: the reservation defers instead of spilling them."""
    from repro_torch.core.hete import PrefetchDeferred

    ctx = make_ctx(capacity=4096)
    a = ctx.malloc((4096,), np.uint8)
    ctx.ensure(a, ACC)
    ctx.protect(a, ACC)
    b = ctx.malloc((4096,), np.uint8)
    with ctx.prefetch_guard():
        with pytest.raises(PrefetchDeferred):
            ctx.ensure(b, ACC)
    assert ctx.ledger.snapshot()["prefetch_deferrals"] == 1
    ctx.unprotect(a, ACC)
    ctx.ensure(b, ACC)  # demand staging may now evict a
    assert ACC not in a.copies


def test_allocator_tags_name_residents():
    ctx = make_ctx(capacity=8192)
    a = ctx.malloc((4096,), np.uint8)
    ctx.ensure(a, ACC)
    arena = ctx.spaces[ACC].arena
    assert list(arena.tags().values()) == [id(a)]


# ---------------------------------------------------------------------------
# runtime + executor integration
# ---------------------------------------------------------------------------


def _pressure_runtime(arena_bytes, **kw):
    from repro_torch.apps.radar import register_kernels
    from repro_torch.core.runtime import Runtime, make_emulated_soc

    pes, ctx = make_emulated_soc(
        n_cpu=0, accelerators=("gpu0",), arena_bytes=arena_bytes,
        device="cpu",
    )
    rt = Runtime(pes, ctx, policy="rimms", scheduler=kw.get(
        "scheduler", "round_robin"))
    register_kernels(rt)
    return rt, ctx


def _jax_pressure_runtime(arena_bytes):
    from repro.apps.radar import register_kernels
    from repro.core.runtime import Runtime, make_emulated_soc

    pes, ctx = make_emulated_soc(
        n_cpu=0, accelerators=("gpu0",), arena_bytes=arena_bytes,
    )
    rt = Runtime(pes, ctx, policy="rimms", scheduler="round_robin")
    register_kernels(rt)
    return rt, ctx


def _radar_tasks(ctx, ways=4, n=512, seed=0):
    from repro_torch.apps.radar import _parallel_fzf

    return _parallel_fzf(ctx, ways, n, use_fragment=True, seed=seed)


def test_serial_pipeline_bit_identical_under_pressure():
    """A radar pipeline whose working set exceeds the arena completes
    with outputs bit-identical to an unconstrained run (serial mode)."""
    ways, n = 4, 512
    parent_bytes = ways * n * 8  # complex64
    roomy, _ = _pressure_runtime(arena_bytes=64 << 20)
    tight, _ = _pressure_runtime(arena_bytes=3 * parent_bytes)

    pts_r, tasks_r = _radar_tasks(roomy.context, ways, n)
    pts_t, tasks_t = _radar_tasks(tight.context, ways, n)
    roomy.run(tasks_r)
    tight.run(tasks_t)
    assert tight.context.ledger.total_evictions > 0
    out_r = hete_sync(pts_r["out"][0], context=roomy.context)
    out_t = hete_sync(pts_t["out"][0], context=tight.context)
    np.testing.assert_array_equal(out_r, out_t)
    # spill stalls surfaced in the timeline + modeled makespan
    assert tight.timeline.total_spill_s > 0.0
    assert tight.last_makespan_model > roomy.last_makespan_model
    # the JAX package under the same pressure: same ledger, same makespan
    from repro.apps.radar import _parallel_fzf as jparallel_fzf

    jtight, _ = _jax_pressure_runtime(arena_bytes=3 * parent_bytes)
    jpts, jtasks = jparallel_fzf(jtight.context, ways, n, use_fragment=True,
                                 seed=0)
    jtight.run(jtasks)
    jhete.hete_sync(jpts["out"][0], context=jtight.context)  # as out_t
    assert (tight.context.ledger.snapshot()
            == jtight.context.ledger.snapshot())
    assert tight.last_makespan_model == jtight.last_makespan_model
    assert tight.timeline.total_spill_s == jtight.timeline.total_spill_s


def test_graph_pipeline_bit_identical_under_pressure():
    """Graph mode (prefetch + protection) under the same pressure."""
    ways, n = 4, 512
    parent_bytes = ways * n * 8
    roomy, _ = _pressure_runtime(arena_bytes=64 << 20)
    tight, _ = _pressure_runtime(arena_bytes=3 * parent_bytes)

    pts_r, tasks_r = _radar_tasks(roomy.context, ways, n)
    pts_t, tasks_t = _radar_tasks(tight.context, ways, n)
    roomy.run_graph(tasks_r)
    tight.run_graph(tasks_t)
    assert tight.context.ledger.total_evictions > 0
    out_r = hete_sync(pts_r["out"][0], context=roomy.context)
    out_t = hete_sync(pts_t["out"][0], context=tight.context)
    np.testing.assert_array_equal(out_r, out_t)
    # all protection claims released at run end
    assert not tight.context._protected


def test_worker_pool_persists_across_run_graph_calls():
    import threading

    rt, ctx = _pressure_runtime(arena_bytes=64 << 20)
    _, tasks1 = _radar_tasks(ctx, 2, 256, seed=1)
    rt.run_graph(tasks1)
    pool = rt._worker_pool
    assert pool is not None and pool.runs_served == 1
    before = threading.active_count()
    _, tasks2 = _radar_tasks(ctx, 2, 256, seed=2)
    rt.run_graph(tasks2)
    assert rt._worker_pool is pool and pool.runs_served == 2
    assert threading.active_count() == before  # no new threads spun up
    rt.close()
    assert rt._worker_pool is None
