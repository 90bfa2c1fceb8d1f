"""The port's hete_Data / hete_Malloc / hete_Free / hete_Sync semantics
(§3.2) against the reference (``tests/test_hete.py``).

Every case of the reference's hete tests runs here on
``repro_torch.core.hete``, over the port's own device spaces: CPU
tensors (``tensor_ingest("cpu")`` / ``tensor_egress``) where the
reference copies numpy arrays.  Where a copy is counted or an extent
reserved, the same sequence runs on the JAX package too (over its own
numpy spaces, as its tests build them) and the ledger snapshots (copies,
bytes, per-pair counts, evictions) and the arena's used bytes and
allocation counts must be equal.  The basename differs from
``tests/test_torch_hete.py``, which holds the port's own memory tests.
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
    HeteContext=HeteContext, MemorySpace=MemorySpace, ACC=ACC, HOST=HOST,
    ingest=tensor_ingest("cpu"), egress=tensor_egress, hete_sync=hete_sync)
J = types.SimpleNamespace(
    HeteContext=jhete.HeteContext, MemorySpace=jhete.MemorySpace,
    ACC=jlocations.Location("device", "acc0"), HOST=jlocations.HOST,
    ingest=lambda a: a.copy(), egress=lambda a: np.asarray(a),
    hete_sync=jhete.hete_sync)


def make_ctx(tracking="flag", P=T, capacity=1 << 20):
    ctx = P.HeteContext(tracking=tracking)
    ctx.register_space(P.MemorySpace(
        P.ACC, capacity=capacity, allocator="nextfit",
        ingest=P.ingest, egress=P.egress,
    ))
    return ctx


def _evidence(ctx, P):
    arena = ctx.spaces[P.ACC].arena
    return (ctx.ledger.snapshot(), dict(ctx.ledger.bytes_moved),
            arena.used_bytes, arena.n_allocs)


def _both(scenario, **kw):
    """Run ``scenario(P, ctx)`` on the port and on the JAX package; the
    ledgers and arena counters must be equal.  Returns the port's
    context and the scenario's result."""
    out = {}
    for key, P in (("T", T), ("J", J)):
        ctx = make_ctx(P=P, **kw)
        out[key] = ctx, scenario(P, ctx)
    assert _evidence(out["T"][0], T) == _evidence(out["J"][0], J)
    return out["T"]


def test_malloc_gives_host_buffer():
    ctx = make_ctx()
    hd = ctx.malloc((16,), np.float32)
    assert hd.data.shape == (16,)
    assert hd.last_location == HOST


def test_arena_reservation_and_free():
    ctx = make_ctx()
    arena = ctx.spaces[ACC].arena
    hd = ctx.malloc((1024,), np.uint8, spaces=[ACC])
    assert arena.used_bytes == 1024
    ctx.free(hd)
    assert arena.used_bytes == 0


def test_flag_check_and_single_copy():
    def scenario(P, ctx):
        hd = ctx.malloc((8,), np.float32)
        hd.data[:] = 3.0
        v1 = ctx.ensure(hd, P.ACC)  # one copy
        assert ctx.ledger.total_copies == 1
        ctx.mark_written(hd, P.ACC, v1 * 2)
        assert hd.last_location == P.ACC
        return hd, P.hete_sync(hd, context=ctx)  # one copy back

    ctx, (hd, out) = _both(scenario)
    np.testing.assert_allclose(out, 6.0)
    assert ctx.ledger.total_copies == 2


def test_faithful_flag_recopies_on_read_after_other_reader():
    """Paper semantics: a single last-resource flag → re-reading at a
    location that is not the flagged one re-copies (see DESIGN.md)."""
    def scenario(P, ctx):
        hd = ctx.malloc((8,), np.float32)
        ctx.ensure(hd, P.ACC)
        ctx.ensure(hd, P.ACC)  # flag HOST → copies again unless cached

    ctx, _ = _both(scenario, tracking="flag")
    assert ctx.ledger.total_copies == 2
    # cached (beyond-paper) mode keeps read replicas
    ctx2, _ = _both(scenario, tracking="cached")
    assert ctx2.ledger.total_copies == 1


def test_write_invalidates_replicas():
    ctx = make_ctx(tracking="cached")
    hd = ctx.malloc((4,), np.float32)
    v = ctx.ensure(hd, ACC)
    ctx.mark_written(hd, ACC, v + 1)
    assert hd.valid_at == {ACC}


def test_fragment_indexing_and_views():
    ctx = make_ctx()
    hd = ctx.malloc((8 * 4,), np.float32)
    frags = hd.fragment(4)
    assert len(hd) == 8 and len(frags) == 8
    hd[3].data[:] = 7.0
    assert hd.data[12:16].tolist() == [7.0] * 4  # zero-copy view
    with pytest.raises(ValueError):
        hd[0].fragment(2)  # no nested fragmentation


def test_fragment_own_flags():
    ctx = make_ctx()
    hd = ctx.malloc((16,), np.float32)
    hd.fragment(8)
    v = ctx.ensure(hd[0], ACC)
    ctx.mark_written(hd[0], ACC, v)
    assert hd[0].last_location == ACC
    assert hd[1].last_location == HOST  # sibling unaffected


def test_fragment_requires_divisor():
    ctx = make_ctx()
    hd = ctx.malloc((10,), np.float32)
    with pytest.raises(ValueError):
        hd.fragment(3)


def test_use_after_free_raises():
    ctx = make_ctx()
    hd = ctx.malloc((4,), np.float32)
    ctx.free(hd)
    with pytest.raises(AllocError):
        ctx.ensure(hd, ACC)
    with pytest.raises(AllocError):
        ctx.free(hd)


def test_ensure_reserves_arena_extent_on_materialization():
    """Device copies materialized by ensure() must
    reserve an extent, so MemorySpace.capacity is enforced at dispatch."""
    def scenario(P, ctx):
        arena = ctx.spaces[P.ACC].arena
        hd = ctx.malloc((1024,), np.uint8)  # no spaces= → nothing reserved
        assert arena.used_bytes == 0
        ctx.ensure(hd, P.ACC)
        assert arena.used_bytes == 1024
        ctx.ensure(hd, P.ACC)  # re-copy (flag mode) must NOT double-reserve
        assert arena.used_bytes == 1024
        return hd

    ctx, hd = _both(scenario)
    ctx.free(hd)
    assert ctx.spaces[ACC].arena.used_bytes == 0


def test_mark_written_reserves_arena_extent():
    ctx = make_ctx()
    arena = ctx.spaces[ACC].arena
    hd = ctx.malloc((512,), np.uint8)
    ctx.mark_written(hd, ACC, np.ones((512,), np.uint8))
    assert arena.used_bytes == 512
    ctx.free(hd)
    assert arena.used_bytes == 0


def test_ensure_raises_clear_allocerror_on_exhaustion():
    """Exhaustion evicts transparently; AllocError surfaces
    only when the pinned working set genuinely exceeds capacity."""
    ctx = HeteContext()
    ctx.register_space(MemorySpace(
        ACC, capacity=4096, allocator="nextfit",
        ingest=lambda a: a.copy(), egress=lambda a: np.asarray(a),
    ))
    big = ctx.malloc((3000,), np.uint8)
    ctx.ensure(big, ACC)
    too_big = ctx.malloc((3000,), np.uint8)
    with big.pinned(ACC):  # pinned resident → nothing evictable
        with pytest.raises(AllocError, match="exhausted"):
            ctx.ensure(too_big, ACC)
    # unpinned: the runtime spills `big` back to host and retries
    ctx.ensure(too_big, ACC)
    assert ctx.ledger.total_evictions == 1
    assert ACC not in big.copies and big.last_location.kind == "host"


def test_fragment_reservation_charges_parent_once():
    """§3.2.3: materializing fragments charges ONE parent-sized extent —
    one arena search covers all n fragments."""
    def scenario(P, ctx):
        hd = ctx.malloc((64,), np.float32)
        hd.fragment(16)
        for i in range(4):
            ctx.ensure(hd[i], P.ACC)
        return hd

    ctx, hd = _both(scenario)
    arena = ctx.spaces[ACC].arena
    assert arena.n_allocs == 1
    assert arena.used_bytes == hd.nbytes
    ctx.free(hd)
    assert arena.used_bytes == 0


def test_fragment_of_device_parent():
    """Fragments of a parent whose valid copy lives
    on a device must not expose the stale host view — ensure/sync on the
    fragment resolves to the device bytes (pinned semantics)."""
    ctx = make_ctx()
    hd = ctx.malloc((16,), np.float32)
    hd.data[:] = 1.0
    dev = ctx.ensure(hd, ACC)
    ctx.mark_written(hd, ACC, dev * 3.0)  # device now holds the valid bytes
    assert hd.last_location == ACC
    frags = hd.fragment(8)
    for f in frags:
        assert f.last_location == ACC  # inherits the parent's flag
        np.testing.assert_allclose(hete_sync(f, context=ctx), 3.0)
    # sync wrote through the zero-copy view: parent host buffer is current
    np.testing.assert_allclose(hd.data, 3.0)


def test_parent_write_after_fragment_propagates_to_fragments():
    """Coherence: a whole-parent write supersedes fragment copies — a
    fragment read afterwards sees the new bytes, on device and host."""
    ctx = make_ctx()
    hd = ctx.malloc((16,), np.float32)
    hd.data[:] = 1.0
    dev = ctx.ensure(hd, ACC)
    ctx.mark_written(hd, ACC, dev * 2.0)
    hd.fragment(8)
    # rewrite the WHOLE parent on device after fragmentation
    ctx.mark_written(hd, ACC, ctx.ensure(hd, ACC) * 2.0)  # now 4.0
    for f in hd.fragments:
        assert f.last_location == ACC
        np.testing.assert_allclose(hete_sync(f, context=ctx), 4.0)
    # host-side whole-parent write must keep the zero-copy views intact
    ctx.mark_written(hd, HOST, np.full((16,), 7.0, np.float32))
    assert hd[0].last_location == HOST
    np.testing.assert_allclose(hd[0].data, 7.0)


def test_fragment_write_then_whole_parent_read_gathers():
    """Coherence: fragment device writes are visible to a later whole-
    parent read (ensure/sync gathers the fragments' bytes first)."""
    def scenario(P, ctx):
        hd = ctx.malloc((16,), np.float32)
        hd.data[:] = 1.0
        frags = hd.fragment(8)
        v = ctx.ensure(frags[0], P.ACC)
        ctx.mark_written(frags[0], P.ACC, v * 5.0)  # fragment 0 → 5.0
        return hd, P.hete_sync(hd, context=ctx)  # whole-parent read

    ctx, (hd, out) = _both(scenario)
    np.testing.assert_allclose(out[:8], 5.0)
    np.testing.assert_allclose(out[8:], 1.0)
    assert hd.last_location == HOST


def test_parent_host_sync_keeps_fragment_views_aliased():
    """Coherence: a whole-parent device→host sync must copy into the
    existing host buffer (not rebind it), so fragment views stay aliased
    and later host-side parent writes remain visible to fragments."""
    ctx = make_ctx()
    hd = ctx.malloc((16,), np.float32)
    hd.data[:] = 1.0
    hd.fragment(8)
    dev = ctx.ensure(hd, ACC)
    ctx.mark_written(hd, ACC, dev * 2.0)
    np.testing.assert_allclose(hete_sync(hd, context=ctx), 2.0)  # parent sync
    ctx.mark_written(hd, HOST, np.full((16,), 7.0, np.float32))
    np.testing.assert_allclose(hd[0].data, 7.0)  # view still aliases
    np.testing.assert_allclose(hete_sync(hd[0], context=ctx), 7.0)


def test_free_parent_frees_fragments():
    ctx = make_ctx()
    hd = ctx.malloc((16,), np.float32)
    frags = hd.fragment(8)
    with pytest.raises(ValueError):
        ctx.free(frags[0])
    ctx.free(hd)
    assert frags[0].freed
