"""The port's interconnect topology subsystem against the reference
(``tests/test_topology.py``): routing, contention, routed staging
accounting, spill-to-peer eviction, and the HEFT insertion-based slot
search.

Every case of the reference's topology tests runs here on ``repro_torch``
over the port's device spaces (CPU tensors, ``device="cpu"``); a value a
case writes on a device is a tensor, as a port kernel writes it.  Where
a value is computed, the JAX package computes it too and the two must be
equal: every route's hop labels and modeled seconds, each transfer's
contended start and end, the ledger snapshots (per-pair and per-link
counts, bytes and modeled seconds, spills to peer), and the modeled
makespans of serial and graph runs on every preset.
"""

import numpy as np
import pytest
import torch

from repro.core import locations as jlocations
from repro.core import topology as jtopology
from repro_torch.core.executor import commit_slot, insert_slot
from repro_torch.core.hete import (
    HeteContext, MemorySpace, hete_sync, tensor_egress, tensor_ingest,
)
from repro_torch.core.locations import HOST, BandwidthModel, Location
from repro_torch.core.topology import (
    Topology, TopologyBandwidthModel, TopologyError, build_preset,
)

torch.set_num_threads(1)

G0, G1 = Location("device", "gpu0"), Location("device", "gpu1")
JG0, JG1 = jlocations.Location("device", "gpu0"), jlocations.Location(
    "device", "gpu1")
JLOC = {HOST: jlocations.HOST, G0: JG0, G1: JG1}


def _np_space(loc, capacity=None):
    return MemorySpace(
        loc, capacity=capacity,
        ingest=tensor_ingest("cpu"), egress=tensor_egress,
    )


def _dev(x):
    """A device payload: a CPU tensor holding ``x``'s values."""
    return torch.as_tensor(np.asarray(x))


def _jax_preset(name, locs):
    return jtopology.build_preset(name, [JLOC[l] for l in locs])


def _same_route(topo, name, locs, src, dst, n=1 << 20):
    """The port's route and price from ``src`` to ``dst`` equal the JAX
    package's on the same preset."""
    jtopo = _jax_preset(name, locs)
    assert ([l.label for l in topo.route(src, dst)]
            == [l.label for l in jtopo.route(JLOC[src], JLOC[dst])])
    assert topo.seconds(src, dst, n) == jtopo.seconds(JLOC[src], JLOC[dst], n)


def _jax_ctx(preset, caps=(4096, 1 << 20)):
    """The JAX package's context on ``preset`` over numpy spaces, as its
    own topology tests build it."""
    from repro.core import hete as jhete

    ctx = jhete.HeteContext()
    ctx.ledger.bandwidth_model = jtopology.TopologyBandwidthModel(
        _jax_preset(preset, [G0, G1]))
    for loc, cap in zip((JG0, JG1), caps):
        ctx.register_space(jhete.MemorySpace(
            loc, capacity=cap, ingest=lambda a: a.copy(),
            egress=lambda a: np.asarray(a)))
    return ctx


def make_ctx(topology, caps=(4096, 1 << 20)):
    ctx = HeteContext()
    ctx.ledger.bandwidth_model = TopologyBandwidthModel(topology)
    ctx.register_space(_np_space(G0, caps[0]))
    ctx.register_space(_np_space(G1, caps[1]))
    return ctx


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_multi_hop_cost_equals_sum_of_hops():
    topo = build_preset("host_bridged_fpga", [G0, G1])
    hops = topo.route(G0, G1)
    assert [l.label for l in hops] == [
        "device:gpu0->host:cpu", "host:cpu->device:gpu1",
    ]
    n = 1 << 20
    assert topo.seconds(G0, G1, n) == pytest.approx(
        sum(l.seconds(n) for l in hops)
    )
    _same_route(topo, "host_bridged_fpga", [G0, G1], G0, G1)
    # same-location transfers are free and have no hops
    assert topo.route(G0, G0) == ()
    assert TopologyBandwidthModel(topo).seconds(G0, G0, n) == 0.0


def test_dijkstra_prefers_cheap_direct_link():
    topo = build_preset("nvlink_mesh", [G0, G1])
    assert [l.label for l in topo.route(G0, G1)] == [
        "device:gpu0->device:gpu1",
    ]
    # pcie tree: peer traffic turns around at the switch, not the host
    tree = build_preset("pcie_tree", [G0, G1])
    labels = [l.label for l in tree.route(G0, G1)]
    assert labels == [
        "device:gpu0->bridge:pcie0", "bridge:pcie0->device:gpu1",
    ]
    for name, t in (("nvlink_mesh", topo), ("pcie_tree", tree)):
        for src, dst in ((G0, G1), (G1, G0), (HOST, G0), (G1, HOST)):
            _same_route(t, name, [G0, G1], src, dst)


def test_unreachable_location_raises_clear_error():
    topo = build_preset("nvlink_mesh", [G0])
    with pytest.raises(TopologyError, match="no route"):
        topo.route(G0, G1)
    # disconnected node (registered but linkless) also raises
    topo2 = Topology("split")
    topo2.add_link(HOST, G0, bandwidth=1e9)
    topo2.add_node(G1)
    with pytest.raises(TopologyError, match="does not connect"):
        topo2.route(G0, G1)
    with pytest.raises(TopologyError, match="unknown topology preset"):
        build_preset("warp_drive", [G0])


def test_emulated_soc_preset_matches_scalar_model():
    """The flat preset prices exactly like the scalar defaults, so
    swapping it in changes no modeled numbers."""
    topo = TopologyBandwidthModel(build_preset("emulated_soc", [G0, G1]))
    scalar = BandwidthModel()
    for src, dst in [(HOST, G0), (G0, HOST), (G0, G1)]:
        assert topo.seconds(src, dst, 1 << 16) == pytest.approx(
            scalar.seconds(src, dst, 1 << 16)
        )


# ---------------------------------------------------------------------------
# contention
# ---------------------------------------------------------------------------


def test_contention_serializes_transfers_on_shared_bridge_link():
    """Two concurrent host→device transfers to different FPGAs use
    disjoint links (overlap); two to the SAME device share its link and
    serialize."""
    topo = build_preset("host_bridged_fpga", [G0, G1])
    n = 1 << 20
    s0, e0, _ = topo.transfer(HOST, G0, n, at=0.0)
    s1, e1, _ = topo.transfer(HOST, G1, n, at=0.0)
    assert s0 == s1 == 0.0  # disjoint udma links: true overlap
    s2, e2, _ = topo.transfer(HOST, G0, n, at=0.0)
    jtopo = _jax_preset("host_bridged_fpga", [G0, G1])
    assert [(s0, e0), (s1, e1), (s2, e2)] == [
        jtopo.transfer(JLOC[HOST], JLOC[g], n, at=0.0)[:2]
        for g in (G0, G1, G0)]
    assert s2 == pytest.approx(e0)  # queued behind the first transfer
    assert e2 == pytest.approx(e0 + topo.seconds(HOST, G0, n))
    # peek (commit=False) reports the wait without reserving
    topo.reset_contention()
    topo.transfer(HOST, G0, n, at=0.0)
    assert topo.queue_delay(HOST, G0, n, at=0.0) == pytest.approx(
        topo.seconds(HOST, G0, n)
    )
    assert topo.queue_delay(HOST, G1, n, at=0.0) == 0.0


def test_device_to_device_on_bridged_platform_occupies_both_host_links():
    topo = build_preset("host_bridged_fpga", [G0, G1])
    n = 1 << 20
    _, _, hops = topo.transfer(G0, G1, n, at=0.0)
    assert [h[0].label for h in hops] == [
        "device:gpu0->host:cpu", "host:cpu->device:gpu1",
    ]
    # store-and-forward: second hop starts when the first delivered
    assert hops[1][1] == pytest.approx(hops[0][2])


# ---------------------------------------------------------------------------
# routed staging accounting
# ---------------------------------------------------------------------------


def test_stage_records_per_hop_ledger_traffic():
    ctx = make_ctx(build_preset("host_bridged_fpga", [G0, G1]),
                   caps=(1 << 20, 1 << 20))
    a = ctx.malloc((1024,), np.uint8)
    a.data[:] = 3
    v = ctx.ensure(a, G0)
    ctx.mark_written(a, G0, _dev(np.asarray(v)))
    ctx.ensure(a, G1)  # routed device→device: two link crossings
    snap = ctx.ledger.snapshot()
    assert snap["by_pair"]["device:gpu0->host:cpu"] == 1
    assert snap["by_pair"]["host:cpu->device:gpu1"] == 1
    per_link = snap["per_link"]
    assert per_link["device:gpu0->host:cpu"]["bytes"] == 1024
    # modeled seconds equal the route's store-and-forward sum
    bw = ctx.ledger.bandwidth_model
    want = bw.seconds(HOST, G0, 1024) + bw.seconds(G0, G1, 1024)
    assert snap["modeled_seconds"] == pytest.approx(want)
    # the JAX package's context over the same steps: the same ledger
    jctx = _jax_ctx("host_bridged_fpga", caps=(1 << 20, 1 << 20))
    ja = jctx.malloc((1024,), np.uint8)
    ja.data[:] = 3
    jctx.mark_written(ja, JG0, np.asarray(jctx.ensure(ja, JG0)))
    jctx.ensure(ja, JG1)
    assert snap == jctx.ledger.snapshot()


def test_per_link_summary_totals_match_counters():
    ctx = make_ctx(build_preset("nvlink_mesh", [G0, G1]),
                   caps=(1 << 20, 1 << 20))
    a = ctx.malloc((2048,), np.uint8)
    ctx.ensure(a, G0)
    ctx.ensure(a, G1)
    summary = ctx.ledger.per_link_summary()
    assert sum(r["copies"] for r in summary.values()) == (
        ctx.ledger.total_copies
    )
    assert sum(r["modeled_s"] for r in summary.values()) == pytest.approx(
        ctx.ledger.modeled_seconds
    )


# ---------------------------------------------------------------------------
# spill-to-peer eviction
# ---------------------------------------------------------------------------


def test_spill_to_peer_when_link_cheaper_than_host():
    ctx = make_ctx(build_preset("nvlink_mesh", [G0, G1]))
    a = ctx.malloc((4096,), np.uint8)
    a.data[:] = 7
    v = ctx.ensure(a, G0)
    payload = (np.asarray(v) ^ 0xFF).astype(np.uint8)
    ctx.mark_written(a, G0, _dev(payload))  # dirty on gpu0
    b = ctx.malloc((4096,), np.uint8)
    ctx.ensure(b, G0)  # evicts a → peer gpu1 (100 GB/s beats 20 GB/s)
    snap = ctx.ledger.snapshot()
    jctx = _jax_ctx("nvlink_mesh")
    ja = jctx.malloc((4096,), np.uint8)
    ja.data[:] = 7
    jctx.mark_written(ja, JG0, np.asarray(jctx.ensure(ja, JG0)) ^ 0xFF)
    jctx.ensure(jctx.malloc((4096,), np.uint8), JG0)
    assert snap == jctx.ledger.snapshot()
    assert snap["spills_to_peer"] == 1
    assert snap["peer_writeback_bytes"] == 4096
    assert snap["by_pair"]["device:gpu0->device:gpu1"] == 1
    assert a.last_location == G1 and G0 not in a.copies
    # the root's extent migrated: gone from gpu0's arena, live in gpu1's
    assert id(a) not in ctx.spaces[G0].arena.tags().values()
    assert id(a) in ctx.spaces[G1].arena.tags().values()
    # host bytes were NOT touched by the spill (still stale)…
    np.testing.assert_array_equal(a.data, 7)
    # …until sync pulls from the peer, bit-identically
    np.testing.assert_array_equal(hete_sync(a, context=ctx), payload)


def test_host_bridged_platform_never_spills_to_peer():
    """When every peer route goes through the host, host write-back is
    always at least as cheap — spill stays host-bound."""
    ctx = make_ctx(build_preset("host_bridged_fpga", [G0, G1]))
    a = ctx.malloc((4096,), np.uint8)
    v = ctx.ensure(a, G0)
    ctx.mark_written(a, G0, _dev(np.asarray(v) + 1))
    b = ctx.malloc((4096,), np.uint8)
    ctx.ensure(b, G0)
    snap = ctx.ledger.snapshot()
    assert snap["total_evictions"] == 1
    assert snap["spills_to_peer"] == 0
    assert a.last_location == HOST


def test_spill_to_peer_skipped_when_peer_full():
    """A peer arena without room cannot take the spill (no cascades):
    write-back falls back to host."""
    ctx = make_ctx(build_preset("nvlink_mesh", [G0, G1]),
                   caps=(4096, 4096))
    filler = ctx.malloc((4096,), np.uint8)
    ctx.ensure(filler, G1)  # peer arena now full
    with filler.pinned(G1):
        a = ctx.malloc((4096,), np.uint8)
        v = ctx.ensure(a, G0)
        ctx.mark_written(a, G0, _dev(np.asarray(v) + 9))
        b = ctx.malloc((4096,), np.uint8)
        ctx.ensure(b, G0)
        assert ctx.ledger.snapshot()["spills_to_peer"] == 0
        assert a.last_location == HOST


def test_spill_to_peer_preserves_fragment_aliasing_and_sync():
    """Evicting a parent whose fragments were written on gpu0 spills the
    dirty fragments device→device; host views stay aliased and sync is
    bit-identical."""
    ctx = make_ctx(build_preset("nvlink_mesh", [G0, G1]))
    parent = ctx.malloc((1024,), np.float32)  # 4096 B
    parent.data[:] = 1.0
    frags = parent.fragment(256)
    v0 = ctx.ensure(frags[0], G0)
    ctx.mark_written(frags[0], G0, _dev(np.asarray(v0) * 5.0))
    v2 = ctx.ensure(frags[2], G0)
    ctx.mark_written(frags[2], G0, _dev(np.asarray(v2) * 9.0))

    other = ctx.malloc((1024,), np.float32)
    ctx.ensure(other, G0)  # evicts parent → dirty fragments to gpu1
    snap = ctx.ledger.snapshot()
    assert snap["spills_to_peer"] == 1
    assert snap["peer_writeback_bytes"] == 2 * 256 * 4
    assert frags[0].last_location == G1 and frags[2].last_location == G1
    assert frags[1].last_location == HOST  # clean fragment untouched
    # host parent bytes still stale for the dirty fragments…
    np.testing.assert_allclose(parent.data[:256], 1.0)
    # …and sync through the aliased views restores coherence
    np.testing.assert_allclose(hete_sync(frags[0], context=ctx), 5.0)
    np.testing.assert_allclose(hete_sync(frags[2], context=ctx), 9.0)
    np.testing.assert_allclose(parent.data[:256], 5.0)
    np.testing.assert_allclose(parent.data[512:768], 9.0)
    # fragment views still write through to the parent
    frags[1].data[:] = 3.0
    np.testing.assert_allclose(parent.data[256:512], 3.0)
    # whole-parent sync gathers spilled fragments bit-identically
    out = hete_sync(parent, context=ctx)
    np.testing.assert_allclose(out[:256], 5.0)
    np.testing.assert_allclose(out[256:512], 3.0)


def test_scalar_model_multi_device_never_spills_to_peer():
    """Spill-to-peer is a topology opt-in: under the default scalar
    model (where device↔device happens to be priced cheaply) eviction
    must stay host-bound so pre-topology semantics hold exactly."""
    ctx = HeteContext()  # default scalar BandwidthModel
    ctx.register_space(_np_space(G0, 4096))
    ctx.register_space(_np_space(G1, 1 << 20))
    a = ctx.malloc((4096,), np.uint8)
    v = ctx.ensure(a, G0)
    ctx.mark_written(a, G0, _dev(np.asarray(v) + 1))
    b = ctx.malloc((4096,), np.uint8)
    ctx.ensure(b, G0)  # evicts dirty a
    snap = ctx.ledger.snapshot()
    assert snap["spills_to_peer"] == 0
    assert a.last_location == HOST and G1 not in a.copies


def test_whole_parent_spill_moves_bytes_once():
    """A fragmented parent written wholesale on the device (root + all
    fragments flagged there) spills with ONE whole-parent transfer;
    fragments receive zero-copy slices of the peer buffer."""
    ctx = make_ctx(build_preset("nvlink_mesh", [G0, G1]))
    parent = ctx.malloc((4096,), np.uint8)
    parent.fragment(1024)
    v = ctx.ensure(parent, G0)
    ctx.mark_written(parent, G0, _dev(np.asarray(v) + 5))  # root + frags at G0
    other = ctx.malloc((4096,), np.uint8)
    ctx.ensure(other, G0)  # evicts parent → peer
    snap = ctx.ledger.snapshot()
    assert snap["spills_to_peer"] == 1
    assert snap["by_pair"]["device:gpu0->device:gpu1"] == 1  # one copy
    assert snap["per_link"]["device:gpu0->device:gpu1"]["bytes"] == 4096
    assert parent.last_location == G1
    for i in range(4):
        frag = parent[i]
        assert frag.last_location == G1
        # zero-copy: the fragment's peer view aliases the parent buffer
        assert np.shares_memory(frag.copies[G1], parent.copies[G1])
    np.testing.assert_array_equal(hete_sync(parent, context=ctx), 5)


def test_scalar_model_single_device_unaffected():
    """Without a topology and with no peer, eviction behaves exactly as
    before (host write-back, scalar one-record accounting)."""
    ctx = HeteContext()
    ctx.register_space(_np_space(G0, 4096))
    a = ctx.malloc((4096,), np.uint8)
    v = ctx.ensure(a, G0)
    ctx.mark_written(a, G0, _dev(np.asarray(v) + 1))
    b = ctx.malloc((4096,), np.uint8)
    ctx.ensure(b, G0)
    snap = ctx.ledger.snapshot()
    assert snap["spills_to_peer"] == 0
    assert snap["by_pair"]["device:gpu0->host:cpu"] == 1
    assert a.last_location == HOST


# ---------------------------------------------------------------------------
# runtime integration
# ---------------------------------------------------------------------------


def _topo_runtime(topology, scheduler="round_robin", arena_bytes=64 << 20):
    from repro_torch.apps.radar import register_kernels
    from repro_torch.core.runtime import Runtime, make_emulated_soc

    pes, ctx = make_emulated_soc(
        n_cpu=0, accelerators=("gpu0", "gpu1"), arena_bytes=arena_bytes,
        topology=topology, device="cpu",
    )
    rt = Runtime(pes, ctx, policy="rimms", scheduler=scheduler)
    register_kernels(rt)
    return rt, ctx


def test_make_emulated_soc_wires_topology_model():
    rt, ctx = _topo_runtime("nvlink_mesh")
    assert isinstance(ctx.ledger.bandwidth_model, TopologyBandwidthModel)
    assert ctx.ledger.bandwidth_model.topology.name == "nvlink_mesh"
    rt.close()


def test_topologies_are_bit_identical_and_replay_deterministic():
    """The topology changes modeled cost, never data: serial and graph
    outputs match across platforms, and the graph executor's topology
    replay yields the same modeled makespan on every run."""
    from repro_torch.apps.synthetic import build_fork_join

    outs, makespans = [], {}
    for topo in ("nvlink_mesh", "host_bridged_fpga"):
        for mode in ("serial", "graph"):
            rt, ctx = _topo_runtime(topo)
            bufs, tasks = build_fork_join(ctx, ways=2, n=1024, depth=1,
                                          seed=3)
            (rt.run if mode == "serial" else rt.run_graph)(tasks)
            outs.append(hete_sync(bufs["out"], context=ctx))
            makespans[(topo, mode)] = rt.last_makespan_model
            rt.close()
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)
    # the JAX package's modeled makespans on the same builds
    from repro.apps.radar import register_kernels as jregister
    from repro.apps.synthetic import build_fork_join as jbuild
    from repro.core.runtime import Runtime as JRuntime
    from repro.core.runtime import make_emulated_soc as jsoc

    for (topo, mode), m in makespans.items():
        pes, jctx = jsoc(n_cpu=0, accelerators=("gpu0", "gpu1"),
                         arena_bytes=64 << 20, topology=topo)
        jrt = JRuntime(pes, jctx, policy="rimms", scheduler="round_robin")
        jregister(jrt)
        _, jtasks = jbuild(jctx, ways=2, n=1024, depth=1, seed=3)
        (jrt.run if mode == "serial" else jrt.run_graph)(jtasks)
        assert m == jrt.last_makespan_model, (topo, mode)
        jrt.close()
    # bridged platform pays more modeled time on the same schedule
    assert (makespans[("host_bridged_fpga", "graph")]
            > makespans[("nvlink_mesh", "graph")])
    # replay determinism: same build → exactly the same makespan
    rt, ctx = _topo_runtime("nvlink_mesh")
    bufs, tasks = build_fork_join(ctx, ways=2, n=1024, depth=1, seed=3)
    rt.run_graph(tasks)
    m1 = rt.last_makespan_model
    rt.close()
    assert m1 == makespans[("nvlink_mesh", "graph")]


def test_graph_timeline_has_link_transfer_lanes():
    from repro_torch.apps.synthetic import build_fork_join

    rt, ctx = _topo_runtime("pcie_tree")
    _, tasks = build_fork_join(ctx, ways=2, n=1024, depth=1, seed=0)
    rt.run_graph(tasks)
    xfers = rt.timeline.transfers()
    assert xfers, "topology run recorded no transfer lanes"
    links = {x.link for x in xfers}
    assert any("bridge:pcie0" in l for l in links)
    txt = rt.timeline.gantt(40)
    assert "=" in txt and "bridge:pcie0" in txt
    rt.close()


def test_heft_with_topology_runs_and_places_correctly():
    from repro_torch.apps.radar import build_2fzf

    rt, ctx = _topo_runtime("nvlink_mesh", scheduler="heft")
    bufs, tasks = build_2fzf(ctx, 256, seed=4)
    rt.run_graph(tasks)
    want = np.fft.ifft(
        np.fft.fft(bufs["a"].data) * np.fft.fft(bufs["b"].data)
    ).astype(np.complex64)
    np.testing.assert_allclose(
        hete_sync(bufs["out"], context=ctx), want, atol=1e-4)
    rt.close()


# ---------------------------------------------------------------------------
# HEFT insertion-based slot search
# ---------------------------------------------------------------------------


def test_insert_slot_fills_idle_gap():
    busy = []
    commit_slot(busy, 0.0, 1.0)
    commit_slot(busy, 3.0, 1.0)
    # a unit task ready at t=0.5 slides into the [1, 3) gap…
    assert insert_slot(busy, 0.5, 1.0) == 1.0
    # …a 3-unit task does not fit there and appends after the last
    assert insert_slot(busy, 0.5, 3.0) == 4.0
    # earliest inside the gap is honoured
    assert insert_slot(busy, 1.5, 1.0) == 1.5
    # empty timeline: start at earliest
    assert insert_slot([], 2.0, 5.0) == 2.0


def test_insert_slot_commit_keeps_intervals_disjoint():
    busy = []
    for earliest, dur in [(0.0, 2.0), (0.0, 1.0), (0.0, 1.0), (1.0, 0.5)]:
        start = insert_slot(busy, earliest, dur)
        # no overlap with any existing interval
        assert all(start + dur <= s or start >= e for s, e in busy)
        commit_slot(busy, start, dur)
    assert busy == sorted(busy)


# ---------------------------------------------------------------------------
# serial per-link contention + prefetch ordering
# ---------------------------------------------------------------------------


def test_serial_modeled_staging_overlaps_disjoint_routes():
    """Serial run() issues a task's input copies concurrently at the
    task's modeled start: two inputs arriving over disjoint links (host
    uplink vs peer NVLink) overlap — staging costs max(), not sum() —
    matching the graph executor's replay pricing."""
    from repro_torch.core.runtime import Task

    rt, ctx = _topo_runtime("nvlink_mesh")
    n = 1 << 14
    x, y, fy, out = (ctx.malloc((n,), np.complex64) for _ in range(4))
    tasks = [
        Task("fft", [y], [fy], pin="gpu1", name="warm"),  # fy lands on gpu1
        Task("zip", [x, fy], [out], pin="gpu0", name="z"),
    ]
    rt.run(tasks)
    ev = {e.task: e for e in rt.timeline.events()}["z"]
    bw = ctx.ledger.bandwidth_model
    t_host = bw.seconds(HOST, G0, x.nbytes)  # host→gpu0 uplink
    t_peer = bw.seconds(G1, G0, fy.nbytes)   # gpu1→gpu0 NVLink
    comp = rt.cost_model.prior_estimate("zip", "gpu", x.nbytes + fy.nbytes)
    stage_m = (ev.model_end - ev.model_start) - comp
    assert stage_m == pytest.approx(max(t_host, t_peer))
    assert stage_m < t_host + t_peer  # strictly better than store-and-forward
    rt.close()


def test_serial_modeled_staging_serializes_on_shared_link():
    """…but two inputs sharing one link (host-bridged UDMA) queue behind
    each other: per-link contention, not naive overlap."""
    from repro_torch.core.runtime import Task

    rt, ctx = _topo_runtime("host_bridged_fpga")
    n = 1 << 14
    x, y, out = (ctx.malloc((n,), np.complex64) for _ in range(3))
    tasks = [Task("zip", [x, y], [out], pin="gpu0", name="z")]
    rt.run(tasks)
    ev = rt.timeline.events()[0]
    bw = ctx.ledger.bandwidth_model
    t_one = bw.seconds(HOST, G0, x.nbytes)
    comp = rt.cost_model.prior_estimate("zip", "gpu", x.nbytes + y.nbytes)
    stage_m = (ev.model_end - ev.model_start) - comp
    assert stage_m == pytest.approx(2 * t_one)  # serialized on the one link
    # the Gantt transfer lanes on that link must not overlap
    lanes = [t for t in rt.timeline.transfers()
             if t.link == "host:cpu->device:gpu0"]
    assert len(lanes) == 2
    lanes.sort(key=lambda t: t.model_start)
    assert lanes[0].model_end <= lanes[1].model_start + 1e-12
    rt.close()


def test_prefetch_order_issues_least_contended_route_first():
    """Topology-aware prefetch ordering: when a ready batch's input
    routes differ in congestion, the free route's staging is issued
    first; without a topology the submission order is untouched."""
    from repro_torch.core.executor import StreamExecutor
    from repro_torch.core.graph import GraphBuilder
    from repro_torch.core.runtime import Task

    rt, ctx = _topo_runtime("nvlink_mesh")
    ex = StreamExecutor(rt, scheduler="round_robin")
    topo = ctx.ledger.bandwidth_model.topology
    # jam the host→gpu0 uplink with committed traffic
    topo.transfer(HOST, G0, 1 << 24, at=0.0, commit=True)
    n = 1 << 14
    a, b, o1, o2 = (ctx.malloc((n,), np.complex64) for _ in range(4))
    builder = GraphBuilder()
    n0 = builder.add(Task("fft", [a], [o1], name="to_busy_gpu0"))
    n1 = builder.add(Task("fft", [b], [o2], name="to_free_gpu1"))
    ex._nodes.extend([n0, n1])
    assigned = [(0, rt.by_name["gpu0"]), (1, rt.by_name["gpu1"])]
    order = [i for i, _ in ex._prefetch_order(assigned)]
    assert order == [1, 0]  # free route first, congested route last
    # tie (both free) keeps submission order
    topo.reset_contention()
    assert [i for i, _ in ex._prefetch_order(assigned)] == [0, 1]
    ex.close()
    rt.close()
