"""The port's multi-tenant QoS against the reference (``tests/test_qos.py``).

Every case of the reference's QoS tests runs here on the port, with
accelerator spaces on CPU tensors (``device="cpu"``): DRR weighted shares,
backpressure windows, per-tenant arena quotas, fairness reporting,
interference-aware placement, the deterministic QoS replay and the
SessionClosedError shutdown audit.  Where a value is computed, the JAX
package computes it too from the same inputs and the two must be equal:
``fair_replay``'s order, release and finish times on the same synthetic
submissions, ``jain_index``/``fairness_report`` on the same ledger
records, and a session's ``qos_report()`` modeled fields for the same
pinned submissions.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.apps import radar as jradar
from repro.core import graph as jgraph
from repro.core import instrument as jinstrument
from repro.core import qos as jqos
from repro.core import runtime as jruntime
from repro_torch.apps.radar import make_session as _make_session
from repro_torch.apps.radar import submit_2fzf
from repro_torch.core import api as rimms
from repro_torch.core.api import SessionClosedError
from repro_torch.core.graph import TaskNode
from repro_torch.core.hete import AllocError, HeteContext, MemorySpace
from repro_torch.core.instrument import TransferLedger, jain_index
from repro_torch.core.locations import Location
from repro_torch.core.qos import (
    BackpressureFull, QoSManager, QuotaExceeded, fair_replay,
)
from repro_torch.core.runtime import Task

torch.set_num_threads(1)


def make_session(**kw):
    """The port's radar session with accelerator spaces on CPU tensors."""
    return _make_session(device="cpu", **kw)


# ---------------------------------------------------------------------------
# synthetic fair_replay fixtures
# ---------------------------------------------------------------------------


def _stub_rt(pes=("pe0",)):
    return types.SimpleNamespace(
        pes=[types.SimpleNamespace(name=p) for p in pes]
    )


def _chain(nodes, records, client, count, comp=1.0, pe="pe0",
           node_cls=TaskNode, task_cls=Task):
    """Append ``count`` independent one-op tasks for ``client``."""
    for _ in range(count):
        i = len(nodes)
        nodes.append(node_cls(i, task_cls("op", [], [], client=client)))
        records[i] = (pe, (), comp, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def test_fair_replay_weighted_shares_converge():
    """DRR weights are reflected in admitted service: with weights 3:1
    and equal task costs, client A finishes ~3x B's tasks in any prefix
    of the virtual schedule (past the initial window transient)."""
    nodes, records = [], {}
    _chain(nodes, records, "A", 30)
    _chain(nodes, records, "B", 30)
    qos = {"clients": {"A": {"weight": 3.0, "window": 30},
                       "B": {"weight": 1.0, "window": 30}},
           "global_window": 2, "quantum_bytes": 1}
    _, makespan, finish, release = fair_replay(
        _stub_rt(), nodes, records, None, qos)
    assert makespan == 60.0  # one PE, unit tasks, work-conserving
    a_done = max(finish[i] for i in range(30))  # A's last finish
    b_by_then = sum(1 for i in range(30, 60) if finish[i] <= a_done)
    # A finished all 30 by a_done; B should have ~10 (weight ratio 3:1),
    # burst-boundary transient gives a little slack.
    assert 8 <= b_by_then <= 14, (a_done, b_by_then)


def test_fair_replay_equal_weights_interleave_evenly():
    nodes, records = [], {}
    _chain(nodes, records, "A", 20)
    _chain(nodes, records, "B", 20)
    qos = {"clients": {"A": {"weight": 1.0, "window": 20},
                       "B": {"weight": 1.0, "window": 20}},
           "global_window": 2, "quantum_bytes": 1}
    _, _, finish, _ = fair_replay(_stub_rt(), nodes, records, None, qos)
    a_done = max(finish[i] for i in range(20))
    b_done = max(finish[i] for i in range(20, 40))
    assert abs(a_done - b_done) <= 2.0  # neither client starved


def test_fair_replay_window_bounds_backlog():
    """A small backpressure window keeps a flooding client from
    occupying the PE ahead of a light client's task; a huge window (the
    pre-QoS behaviour) starves it."""
    def light_finish(heavy_window):
        nodes, records = [], {}
        _chain(nodes, records, "heavy", 12)
        _chain(nodes, records, "light", 1)
        qos = {"clients": {
            "heavy": {"weight": 1.0, "window": heavy_window},
            "light": {"weight": 1.0, "window": 4},
        }, "quantum_bytes": 1}
        _, _, finish, _ = fair_replay(_stub_rt(), nodes, records, None, qos)
        return finish[12]

    assert light_finish(heavy_window=12) == 13.0  # FCFS: behind everything
    assert light_finish(heavy_window=2) == 3.0  # windowed: behind 2


def test_fair_replay_is_deterministic_and_respects_deps():
    nodes, records = [], {}
    _chain(nodes, records, "A", 6)
    # B's second task depends on its first
    i0 = len(nodes)
    nodes.append(TaskNode(i0, Task("op", [], [], client="B")))
    records[i0] = ("pe0", (), 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    i1 = len(nodes)
    nodes.append(TaskNode(i1, Task("op", [], [], client="B"), deps={i0}))
    nodes[i0].dependents.add(i1)
    records[i1] = ("pe0", (), 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    qos = {"clients": {"A": {"weight": 1.0, "window": 2},
                       "B": {"weight": 1.0, "window": 4}},
           "quantum_bytes": 1}
    runs = [fair_replay(_stub_rt(), nodes, records, None, qos)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    assert runs[0][2] == runs[1][2]  # identical finish maps
    assert runs[0][2][i1] > runs[0][2][i0]  # dep ordering holds


def _mixed_submissions(node_cls, task_cls):
    """Three clients on two PEs: unequal costs, staging, a dependency
    chain and think time — the same submissions for either package."""
    nodes, records = [], {}
    rng = np.random.default_rng(19)
    for k in range(36):
        client = ("A", "B", "C")[k % 3]
        deps = {k - 3} if client == "C" and k >= 3 else set()
        i = len(nodes)
        nodes.append(node_cls(i, task_cls("op", [], [], client=client),
                              deps=deps))
        for d in deps:
            nodes[d].dependents.add(i)
        comp, stage = float(rng.uniform(0.5, 2.0)), float(rng.uniform(0, 0.3))
        records[i] = (("pe0", "pe1")[k % 2], (), comp, stage, 0.0, 0.0,
                      0.0, 0.0, 0.0)
    qos = {"clients": {"A": {"weight": 3.0, "window": 2},
                       "B": {"weight": 1.0, "window": 8, "think_s": 0.25},
                       "C": {"weight": 0.5, "window": 3}},
           "global_window": 4, "quantum_bytes": 1}
    return nodes, records, qos


def _modeled(timeline):
    """A timeline's modeled content (every field but the wall clock's):
    per-PE task lanes in order, then the transfer lanes."""
    events = [(e.task, e.pe, e.model_start, e.model_end, e.transfer_s,
               e.out_transfer_s, e.spill_s, e.compute_start_m, e.node)
              for e in timeline.events()]
    transfers = [(t.link, t.task, t.nbytes, t.model_start, t.model_end,
                  t.node) for t in timeline.transfers()]
    return events, transfers


@pytest.mark.parametrize("case", ["weighted", "mixed"])
def test_fair_replay_equals_reference(case):
    """The same submissions through both packages' ``fair_replay``: the
    same timeline (order, PEs, start and end) and the same release and
    finish time per task, bit for bit."""
    out = []
    for node_cls, task_cls, replay in (
            (TaskNode, Task, fair_replay),
            (jgraph.TaskNode, jruntime.Task, jqos.fair_replay)):
        if case == "weighted":
            nodes, records = [], {}
            _chain(nodes, records, "A", 30, node_cls=node_cls,
                   task_cls=task_cls)
            _chain(nodes, records, "B", 30, comp=0.5, node_cls=node_cls,
                   task_cls=task_cls)
            qos = {"clients": {"A": {"weight": 3.0, "window": 30},
                               "B": {"weight": 1.0, "window": 30}},
                   "global_window": 2, "quantum_bytes": 1}
        else:
            nodes, records, qos = _mixed_submissions(node_cls, task_cls)
        out.append(replay(_stub_rt(("pe0", "pe1")), nodes, records, None,
                          qos))
    (t_tl, t_mk, t_fin, t_rel), (j_tl, j_mk, j_fin, j_rel) = out
    assert t_mk == j_mk
    assert t_fin == j_fin and t_rel == j_rel
    assert sorted(t_fin, key=lambda i: (t_fin[i], i)) == sorted(
        j_fin, key=lambda i: (j_fin[i], i))
    assert _modeled(t_tl) == _modeled(j_tl)


# ---------------------------------------------------------------------------
# backpressure: submit blocks at the window limit, unblocks on completion
# ---------------------------------------------------------------------------


def _gated_registry(gate):
    reg = rimms.OpRegistry()

    @rimms.op("wait", kinds=("cpu",), registry=reg)
    def wait_kernel(ins):
        gate.wait(30)
        return ins[0]

    return reg


def test_submit_blocks_at_window_limit_and_unblocks():
    gate = threading.Event()
    s = rimms.Session.emulated(accelerators=(), n_cpu=1,
                               scheduler="round_robin",
                               registry=_gated_registry(gate), device="cpu")
    try:
        c = s.client("tenant", window=2)
        x = c.malloc((8,), np.float32)
        f1 = c.submit("wait", [x])
        f2 = c.submit("wait", [x])
        # window full: nowait raises instead of blocking
        with pytest.raises(BackpressureFull, match="tenant"):
            c.submit("wait", [x], nowait=True)
        # blocking submit parks until a completion frees the window
        state = {"submitted": None}

        def blocked():
            state["submitted"] = c.submit("wait", [x])

        t = threading.Thread(target=blocked)
        t.start()
        time.sleep(0.15)
        assert state["submitted"] is None  # still backpressured
        assert c.state.inflight == 2
        # Another client with window room is NOT backpressured just
        # because this tenant has waiters: nowait admits via a real DRR
        # pass instead of raising.
        other = s.client("other", window=4)
        y = other.malloc((8,), np.float32)
        f_other = other.submit("wait", [y], nowait=True)
        gate.set()  # kernels complete -> slots free -> submit proceeds
        t.join(timeout=30)
        assert state["submitted"] is not None
        f1.result(timeout=30)
        f2.result(timeout=30)
        f_other.result(timeout=30)
        state["submitted"].result(timeout=30)
        s.barrier()
        # admission stalls were attributed to the tenant
        rep = s.ledger.fairness_report()
        assert rep["clients"]["tenant"]["stall_s"] > 0.0
    finally:
        gate.set()
        s.close()
        s.runtime.close()


def test_failed_tasks_release_window_slots():
    reg = rimms.OpRegistry()

    @rimms.op("boom", kinds=("cpu",), registry=reg)
    def boom(ins):
        raise RuntimeError("kernel exploded")

    with rimms.Session.emulated(accelerators=(), n_cpu=1,
                                scheduler="round_robin",
                                registry=reg, device="cpu") as s:
        c = s.client("t", window=2)
        x = c.malloc((4,), np.float32)
        futs = [c.submit("boom", [x]) for _ in range(6)]  # > window
        for f in futs:
            with pytest.raises(RuntimeError, match="exploded"):
                f.result(timeout=30)
        assert c.state.inflight == 0


# ---------------------------------------------------------------------------
# per-tenant arena quotas
# ---------------------------------------------------------------------------


def test_quota_alloc_error_is_per_tenant():
    """Tenant A exhausting its quota fails alone — tenant B's identical
    work on the same arena keeps completing."""
    s = make_session(policy="rimms", scheduler="round_robin", n_cpu=0,
                     accelerators=("gpu0",), arena_bytes=1 << 20)
    try:
        a = s.client("A", quota_bytes=100 << 10)
        b = s.client("B")
        n = 1 << 15  # 256 KiB complex64 buffers: far over A's quota
        xa = a.malloc((n,), np.complex64)
        fa = a.submit("fft", [xa], pin="gpu0")
        with pytest.raises(QuotaExceeded) as ei:
            fa.result(timeout=60)
        assert ei.value.tenant == "A"
        assert isinstance(ei.value, AllocError)
        # B is unaffected: same size, same arena, no quota
        xb = b.malloc((n,), np.complex64)
        xb.data[:] = 1.0
        out = b.submit("fft", [xb], pin="gpu0").result(timeout=60)
        np.testing.assert_allclose(
            out, np.fft.fft(xb.data).astype(np.complex64), atol=1e-3)
        s.barrier()
    finally:
        s.close()
        s.runtime.close()


def test_quota_evicts_own_buffers_first_to_stay_under_budget():
    """A tenant at quota recycles its *own* arena bytes (evicting its
    LRU buffer) rather than failing, as long as something of its own is
    evictable."""
    s = make_session(policy="rimms", scheduler="round_robin", n_cpu=0,
                     accelerators=("gpu0",), arena_bytes=2 << 20)
    try:
        # one chain in flight (input+output, 512 KiB) fits; the idle
        # buffers of earlier chains do not
        a = s.client("A", quota_bytes=600 << 10)
        n = 1 << 15  # 256 KiB
        outs = []
        for k in range(3):  # serial chains: earlier buffers are idle
            x = a.malloc((n,), np.complex64)
            x.data[:] = k + 1
            outs.append(a.submit("fft", [x], pin="gpu0"))
            outs[-1].result(timeout=60)
        s.barrier()
        assert all(np.all(np.isfinite(o.result(timeout=5))) for o in outs)
        assert s.ledger.client_evictions["A"] > 0  # recycled its own bytes
        assert s.context.tenant_bytes("A", Location("device", "gpu0")) \
            <= 600 << 10
    finally:
        s.close()
        s.runtime.close()


def test_capacity_eviction_prefers_over_quota_tenant():
    """General capacity pressure picks the over-quota tenant's buffer
    first, even when another tenant's buffer is older in LRU order."""
    ctx = HeteContext()
    dev = Location("device", "d0")
    ctx.register_space(MemorySpace(
        dev, capacity=64 << 10, block_size=4096,
        ingest=lambda v: v.copy(), egress=lambda v: np.asarray(v),
    ))
    hb = ctx.malloc((24 << 10,), np.uint8, owner="B")  # older touch (LRU)
    ctx.ensure(hb, dev)
    ha = ctx.malloc((24 << 10,), np.uint8, owner="A")
    ctx.ensure(ha, dev)
    ctx.set_quota("A", 8 << 10)  # A is now over quota
    hc = ctx.malloc((24 << 10,), np.uint8, owner="B")
    ctx.ensure(hc, dev)  # needs an eviction: plain LRU would pick B's
    assert dev not in ha.extents  # over-quota A was preferred
    assert dev in hb.extents
    assert ctx.ledger.client_evictions["A"] == 1


def test_spill_to_peer_respects_peer_arena_quota():
    """The runtime's own eviction path must not push a tenant over its
    budget in a peer arena: write-back falls back to host when the
    cheaper peer spill would exceed the owner's quota there."""
    from repro_torch.core.topology import (TopologyBandwidthModel,
                                           build_preset)

    g0, g1 = Location("device", "gpu0"), Location("device", "gpu1")
    ctx = HeteContext()
    ctx.ledger.bandwidth_model = TopologyBandwidthModel(
        build_preset("nvlink_mesh", [g0, g1]))
    for loc, cap in ((g0, 4096), (g1, 1 << 20)):
        ctx.register_space(MemorySpace(
            loc, capacity=cap, ingest=lambda v: v.copy(),
            egress=lambda v: np.asarray(v)))
    a = ctx.malloc((4096,), np.uint8, owner="A")
    a.data[:] = 7
    v = ctx.ensure(a, g0)
    payload = (np.asarray(v) ^ 0xFF).astype(np.uint8)
    ctx.mark_written(a, g0, payload)  # dirty on gpu0
    ctx.set_quota("A", 2048)  # a fresh 4096 B peer extent would exceed
    b = ctx.malloc((4096,), np.uint8, owner="B")
    ctx.ensure(b, g0)  # evicts a: peer link is cheaper, but quota says host
    snap = ctx.ledger.snapshot()
    assert snap["spills_to_peer"] == 0
    assert a.last_location.kind == "host"
    assert ctx.tenant_bytes("A", g1) == 0
    np.testing.assert_array_equal(a.data, payload)  # written back intact


# ---------------------------------------------------------------------------
# fairness report
# ---------------------------------------------------------------------------


def test_jain_index():
    assert jain_index([]) == 1.0
    assert jain_index([5.0, 5.0, 5.0]) == 1.0
    assert jain_index([1.0, 0.0, 0.0]) == pytest.approx(1 / 3)
    assert 0.5 < jain_index([2.0, 1.0]) < 1.0
    rng = np.random.default_rng(3)
    for xs in ([], [5.0, 5.0], list(rng.uniform(0, 4, size=17))):
        assert jain_index(xs) == jinstrument.jain_index(xs)


def _fed_ledger(ledger_cls, loc_cls):
    led = ledger_cls()
    led.record_client_task("a", 100, 2.0)
    led.record_client_task("b", 50, 1.0)
    led.record_client_stall("b", 0.25)
    led.record_client_failure("b")
    led.record_eviction(loc_cls("device", "d0"), 64, 64, 0.0, owner="a")
    return led


def test_fairness_report_fields_and_weight_normalization():
    led = _fed_ledger(TransferLedger, Location)
    rep = led.fairness_report()
    assert set(rep) == {"clients", "n_clients", "jain_index"}
    assert rep["n_clients"] == 2
    row = rep["clients"]["a"]
    assert set(row) == {"tasks", "bytes", "service_model_s", "stall_s",
                        "evictions", "failures", "weight"}
    assert row["tasks"] == 1 and row["bytes"] == 100
    assert row["evictions"] == 1
    assert rep["clients"]["b"]["stall_s"] == 0.25
    assert rep["clients"]["b"]["failures"] == 1
    # unequal raw service -> index < 1; weights 2:1 normalize it back
    assert rep["jain_index"] < 1.0
    weighted = led.fairness_report(weights={"a": 2.0, "b": 1.0})
    assert weighted["jain_index"] == pytest.approx(1.0)
    # subset selection
    only_a = led.fairness_report(clients=["a"])
    assert only_a["n_clients"] == 1 and only_a["jain_index"] == 1.0
    # the JAX package's ledger fed the same records reports the same
    from repro.core.locations import Location as JLocation

    jled = _fed_ledger(jinstrument.TransferLedger, JLocation)
    assert rep == jled.fairness_report()
    assert weighted == jled.fairness_report(weights={"a": 2.0, "b": 1.0})
    led.reset()
    assert led.fairness_report()["n_clients"] == 0


# ---------------------------------------------------------------------------
# bit-identical outputs under contention vs solo
# ---------------------------------------------------------------------------


def _run_light(session, chains, n):
    rows = []
    for k in range(chains):
        bufs = submit_2fzf(session, n, pins=("gpu0",) * 4, seed=100 + k,
                           tag=f"_k{k}")
        rows.append(bufs["out"].result(timeout=120).copy())
    return rows


def test_bit_identical_under_contention_vs_solo():
    """QoS changes when work runs, never what it computes: a light
    client's chains are bitwise identical with and without a heavy
    tenant flooding the same session."""
    n, chains = 1 << 10, 3

    solo = make_session(policy="rimms", scheduler="round_robin", n_cpu=0,
                        accelerators=("gpu0", "gpu1"))
    solo.client("light", window=4)
    solo_rows = _run_light(solo, chains, n)
    solo.barrier()
    solo.close()
    solo.runtime.close()

    mix = make_session(policy="rimms", scheduler="round_robin", n_cpu=0,
                       accelerators=("gpu0", "gpu1"))
    mix.client("light", window=4)
    mix.client("heavy", weight=0.25, window=4)
    stop = threading.Event()
    errors = []

    def heavy():
        try:
            k = 0
            while not stop.is_set() and k < 12:
                submit_2fzf(mix, n, pins=("gpu0",) * 4, seed=900 + k,
                            tag=f"_h{k}")
                k += 1
        except BaseException as e:  # pragma: no cover - surfaced below
            errors.append(e)

    ht = threading.Thread(target=heavy, name="heavy")
    ht.start()
    light_thread_rows = []

    def light():
        try:
            light_thread_rows.extend(_run_light(mix, chains, n))
        except BaseException as e:  # pragma: no cover - surfaced below
            errors.append(e)

    lt = threading.Thread(target=light, name="light")
    lt.start()
    lt.join(timeout=120)
    stop.set()
    ht.join(timeout=120)
    assert not errors
    mix.barrier()
    mix.close()
    mix.runtime.close()

    assert len(light_thread_rows) == chains
    for got, want in zip(light_thread_rows, solo_rows):
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# interference-aware heft placement
# ---------------------------------------------------------------------------


def test_interference_charges_other_clients_prorated():
    s = make_session(scheduler="heft", n_cpu=0,
                     accelerators=("gpu0", "gpu1"))
    try:
        ex = s._stream
        hd = s.context.malloc((16,), np.complex64)
        task = Task("fft", [hd], [], client="A")
        gpu0 = s.runtime.by_name["gpu0"]
        # co-pending: B could use either gpu (charge est/2), a second A
        # task charges nothing (self-delay is not interference), C is
        # pinned elsewhere
        ex._copending = {
            7: ("B", frozenset({"gpu0", "gpu1"})),
            8: ("A", frozenset({"gpu0"})),
            9: ("C", frozenset({"gpu1"})),
        }
        assert ex._interference(task, gpu0, est=1.0) == pytest.approx(0.5)
        gpu1 = s.runtime.by_name["gpu1"]
        assert ex._interference(task, gpu1, est=1.0) == pytest.approx(1.5)
        # no attribution -> no charge (batch engine behaviour unchanged)
        assert ex._interference(Task("fft", [hd], []), gpu0, 1.0) == 0.0
        ex._copending = {}
        assert ex._interference(task, gpu0, 1.0) == 0.0
    finally:
        s.close()
        s.runtime.close()


def test_interference_spreads_two_clients_across_equal_pes():
    """Two clients' simultaneous independent chains on two equal
    accelerators: interference-aware heft serves both PEs (no client
    pile-up on one device)."""
    s = make_session(scheduler="heft", n_cpu=0,
                     accelerators=("gpu0", "gpu1"))
    try:
        a, b = s.client("A"), s.client("B")
        for cl, tag in ((a, "a"), (b, "b")):
            for k in range(4):
                x = cl.malloc((1 << 12,), np.complex64)
                x.data[:] = k + 1
                cl.submit("fft", [x], name=f"fft_{tag}{k}")
        s.barrier()
        used = {pe for _, pe in s.runtime.task_log}
        assert used == {"gpu0", "gpu1"}
    finally:
        s.close()
        s.runtime.close()


# ---------------------------------------------------------------------------
# SessionClosedError: shutdown path under concurrent submitters
# ---------------------------------------------------------------------------


def test_submit_and_malloc_after_close_raise_session_closed():
    s = make_session(accelerators=("gpu0",))
    s.close()
    with pytest.raises(SessionClosedError):
        s.malloc((8,))
    with pytest.raises(SessionClosedError):
        s.submit("fft", [np.zeros(8, np.complex64)])
    # and it is still the RuntimeError("... closed") contract
    with pytest.raises(RuntimeError, match="closed"):
        s.submit("fft", [np.zeros(8, np.complex64)])
    s.runtime.close()


def test_submit_after_runtime_close_raises_not_hangs():
    """A dead worker pool must surface as SessionClosedError, never as
    a silently enqueued task that no thread will ever run."""
    s = make_session(accelerators=("gpu0",), n_cpu=0,
                     scheduler="round_robin")
    x = s.submit("fft", [np.ones(64, np.complex64)])
    x.result(timeout=30)
    s.barrier()
    s.runtime.close()  # pool gone, session not closed by the user
    with pytest.raises(SessionClosedError):
        s.submit("fft", [np.ones(64, np.complex64)])
    s.close()


def test_concurrent_submitters_race_close_cleanly():
    """N threads submit in a loop while the main thread closes the
    session: every submission either completes normally or raises
    SessionClosedError — nothing hangs, nothing lands on a dead pool."""
    s = make_session(accelerators=("gpu0", "gpu1"), n_cpu=0,
                     scheduler="round_robin")
    unexpected = []
    done = []

    def submitter(i):
        futs = []
        try:
            for k in range(200):
                futs.append(s.submit("fft", [np.ones(256, np.complex64)],
                                     name=f"s{i}_{k}"))
        except SessionClosedError:
            pass
        except BaseException as e:  # pragma: no cover - diagnostic
            unexpected.append(e)
        finally:
            done.append(len(futs))

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    s.close()
    for t in threads:
        t.join(timeout=60)
    assert not unexpected
    assert len(done) == 4
    # everything admitted before the close completed (close drains)
    rep = s.report()
    assert rep["n_completed"] + rep["n_failed"] == rep["n_tasks"]
    s.runtime.close()


# ---------------------------------------------------------------------------
# session-level QoS report plumbing
# ---------------------------------------------------------------------------


def test_qos_report_latencies_and_fairness():
    s = make_session(policy="rimms", scheduler="round_robin", n_cpu=0,
                     accelerators=("gpu0", "gpu1"))
    try:
        a = s.client("A", window=4)
        b = s.client("B", window=4)
        fa = a.submit("fft", [np.ones(1 << 10, np.complex64)], pin="gpu0")
        fb = b.submit("fft", [np.ones(1 << 10, np.complex64)], pin="gpu1")
        fa.result(timeout=30)
        fb.result(timeout=30)
        s.barrier()
        rep = s.qos_report()
        assert rep["makespan_model"] > 0
        for f in (fa, fb):
            assert f.node is not None
            assert rep["release_model"][f.node] == 0.0
            assert rep["finish_model"][f.node] > 0.0
        fairness = rep["fairness"]
        assert set(fairness["clients"]) >= {"A", "B"}
        assert fairness["jain_index"] == pytest.approx(1.0)
        assert rep["qos"]["clients"]["A"]["window"] == 4
    finally:
        s.close()
        s.runtime.close()


def _pinned_tenants(make, submit):
    """Three tenants' pinned 2FZF chains submitted from one thread (a
    fixed submission order), then the session's QoS report."""
    s = make(policy="rimms", scheduler="round_robin", n_cpu=0,
             accelerators=("gpu0", "gpu1"), global_window=6)
    try:
        s.client("A", weight=2.0, window=4, slo_latency_s=5e-4)
        s.client("B", weight=1.0, window=4, slo_latency_s=60.0)
        s.client("C", weight=0.5, window=8, think_s=1e-4,
                 slo_latency_s=10e-6, slo_target=0.9)
        futs = []
        for k in range(9):
            name = ("A", "B", "C")[k % 3]
            pe = ("gpu0", "gpu1")[k % 2]
            bufs = submit(s.client(name), 1 << 10, pins=(pe,) * 4,
                          seed=40 + k, tag=f"_{name}{k}")
            futs.append(bufs["out"])
        outs = [f.result(timeout=120) for f in futs]
        s.barrier()
        rep = s.qos_report()
    finally:
        s.close()
        s.runtime.close()
    return rep, outs


class _ClientSession:
    """A session client that quacks like a session for ``submit_2fzf``:
    buffers and tasks are the client's."""

    def __init__(self, client):
        self.c = client

    def malloc(self, *a, **kw):
        return self.c.malloc(*a, **kw)

    def submit(self, *a, **kw):
        return self.c.submit(*a, **kw)


def test_qos_report_modeled_fields_equal_reference():
    """The same pinned submissions of three weighted, windowed tenants
    (one closed-loop, each with a latency SLO) through a port session
    and a JAX session: release and finish per task, makespan, per-client
    latency percentiles, SLO burn rates, the QoS parameters and the
    fairness report's modeled columns are equal."""
    def submit(c, n, **kw):
        return submit_2fzf(_ClientSession(c), n, **kw)

    def jsubmit(c, n, **kw):
        return jradar.submit_2fzf(_ClientSession(c), n, **kw)

    rep, outs = _pinned_tenants(make_session, submit)
    jrep, jouts = _pinned_tenants(jradar.make_session, jsubmit)
    for key in ("makespan_model", "release_model", "finish_model",
                "latency_percentiles", "slo", "qos"):
        assert rep[key] == jrep[key], key
    assert _modeled(rep["timeline"]) == _modeled(jrep["timeline"])
    modeled = ("tasks", "bytes", "service_model_s", "evictions",
               "failures", "weight")
    for name in ("A", "B", "C"):
        got = rep["fairness"]["clients"][name]
        want = jrep["fairness"]["clients"][name]
        assert {k: got[k] for k in modeled} == {k: want[k] for k in modeled}
    assert rep["slo"]["C"]["breached"] and not rep["slo"]["B"]["breached"]
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.sqrt(1 << 10))


def test_qos_manager_client_update_and_validation():
    q = QoSManager(default_window=8)
    a = q.client("a", weight=2.0)
    assert a.window == 8 and a.weight == 2.0
    assert q.client("a", window=3) is a and a.window == 3
    with pytest.raises(ValueError):
        q.client("bad", weight=0.0)
    with pytest.raises(ValueError):
        q.client("bad2", window=0)
    params = q.params()
    assert params["clients"]["a"] == {"weight": 2.0, "window": 3,
                                      "quota_bytes": None, "think_s": 0.0,
                                      "slo_latency_s": None,
                                      "slo_target": 0.99}
    jq = jqos.QoSManager(default_window=8)
    jq.client("a", weight=2.0)
    jq.client("a", window=3)
    assert params == jq.params()
