"""The port's tracing and metrics against the reference (``tests/test_trace.py``).

Every case of the reference's trace tests runs here on the port, with
accelerator spaces on CPU tensors (``device="cpu"``): ring buffers,
Perfetto export, histograms and the ``trace_lint`` invariant checker.
Where a value is computed, the JAX package computes it too from the same
inputs and the two must be equal: the modeled process group and the
ledger metadata of a traced run, histogram percentiles and registry
snapshots fed the same samples, and ``trace_lint``'s verdict on the same
documents.
"""

import importlib
import json
import threading

import numpy as np
import pytest
import torch

from repro.apps import radar as jradar
from repro.core import api as jrimms
from repro_torch.apps import radar as tradar
from repro_torch.apps.radar import build_2fzf, submit_2fzf
from repro_torch.apps.radar import make_runtime as _make_runtime
from repro_torch.apps.radar import make_session as _make_session
from repro_torch.core import api as rimms
from repro_torch.core.trace import (
    MODEL_PID,
    WALL_PID,
    Histogram,
    MetricsRegistry,
    TraceCollector,
    global_collector,
    trace,
    trace_lint,
)

# the module (``repro.core`` re-exports its ``trace`` function by that name)
jtrace_mod = importlib.import_module("repro.core.trace")

torch.set_num_threads(1)


def make_runtime(**kw):
    """The port's radar runtime with accelerator spaces on CPU tensors."""
    return _make_runtime(device="cpu", **kw)


def make_session(**kw):
    """The port's radar session with accelerator spaces on CPU tensors."""
    return _make_session(device="cpu", **kw)


# ---------------------------------------------------------------------------
# collector mechanics
# ---------------------------------------------------------------------------


def test_ring_buffer_bounds_memory_and_counts_drops():
    tc = TraceCollector(capacity_per_thread=4)
    for i in range(10):
        tc.instant(f"e{i}", "test", "t")
    assert tc.event_count() == 4
    assert tc.drops() == 6
    # drops surface as a lint violation: the trace is incomplete
    assert any("dropped" in v for v in trace_lint(tc.export()))


def test_disabled_collector_records_nothing():
    tc = TraceCollector()
    tc.pause()
    tc.instant("e", "test", "t")
    tc.span("s", "test", "t", 0.0, 1.0)
    tc.transfer("ctx0", "host", "gpu0", 128, 0.1)
    assert tc.event_count() == 0
    tc.resume()
    tc.instant("e", "test", "t")
    assert tc.event_count() == 1


def test_per_thread_rings_need_no_lock_on_hot_path():
    tc = TraceCollector(capacity_per_thread=1 << 12)
    n, threads = 1000, 4

    def emit(k):
        for i in range(n):
            tc.instant(f"t{k}.{i}", "test", f"thr:{k}")

    ts = [threading.Thread(target=emit, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert tc.event_count() == n * threads
    assert tc.drops() == 0


def test_export_structure_is_perfetto_loadable():
    tc = TraceCollector()
    t0 = tc.now()
    tc.span("work", "compute", "pe:gpu0", t0, t0 + 0.001, {"task": "work"})
    tc.instant("evict", "memory", "mem:gpu0", {"nbytes": 64})
    doc = tc.export()
    json.dumps(doc)  # must be JSON-serializable
    evs = doc["traceEvents"]
    pids = {e["pid"] for e in evs}
    assert WALL_PID in pids
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"pe:gpu0", "mem:gpu0"} <= names
    xs = [e for e in evs if e["ph"] == "X"]
    assert len(xs) == 1 and xs[0]["dur"] > 0 and xs[0]["cat"] == "compute"
    insts = [e for e in evs if e["ph"] == "i"]
    assert insts and all(e["s"] == "t" for e in insts)
    assert doc["rimms"]["drops"] == 0


def test_modeled_and_wall_land_in_separate_process_groups():
    rt, ctx = make_runtime(policy="rimms", accelerators=("gpu0",))
    with trace(context=ctx) as tc:
        _, tasks = build_2fzf(ctx, 64, pins=("gpu0",) * 4)
        rt.run(tasks)
        doc = tc.export()
    by_pid = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            by_pid.setdefault(e["pid"], set()).add(e["cat"])
    assert "compute" in by_pid[WALL_PID]
    assert "compute" in by_pid[MODEL_PID]
    assert trace_lint(doc) == []
    assert ctx.tracer is None  # detached on exit


def _traced_serial_2fzf(radar, trace_ctx, **kw):
    rt, ctx = radar.make_runtime(policy="rimms", accelerators=("gpu0",),
                                 **kw)
    with trace_ctx(context=ctx) as tc:
        _, tasks = radar.build_2fzf(ctx, 256, pins=("gpu0",) * 4, seed=3)
        rt.run(tasks)
        doc = tc.export()
    rt.close()
    return doc


def _modeled_events(doc):
    """The modeled process group, with the wall-clock instants that ride
    in its compute spans' args left out."""
    out = []
    for e in doc["traceEvents"]:
        if e.get("pid") != MODEL_PID:
            continue
        e = dict(e)
        if "args" in e:
            e["args"] = {k: v for k, v in e["args"].items()
                         if k not in ("wall_start", "wall_end")}
        out.append(e)
    return out


def test_abutting_wall_spans_late_in_a_trace_do_not_overlap():
    """Spans that share one ``perf_counter`` reading, the end of one and
    the start of the next on the same exclusive track, stay exclusive
    however far into the trace they fall: 19 s in, a float64 step of the
    microsecond timestamps is ~4e-9 us, above ``trace_lint``'s 1e-9 us,
    so a span's end is exported from the same rounded offset the next
    span starts at, not as its start plus its own rounded length."""
    tc = TraceCollector()
    rng = np.random.default_rng(11)
    t = tc._t0 + 19.092973
    cats = ("compute", "writeback")
    for i in range(4000):
        t1 = t + float(rng.uniform(1e-6, 1e-3))
        tc.span("join0_p15", cats[i % 2], "pe:cpu0", t, t1)
        t = t1
    doc = tc.export()
    assert trace_lint(doc) == []
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == 4000
    assert all(b["ts"] == a["ts"] + a["dur"] for a, b in zip(xs, xs[1:]))


def test_modeled_trace_and_ledger_meta_equal_reference():
    """A traced serial 2FZF chain on one accelerator: the port's modeled
    events (names, tracks, start, duration, flow arrows) and its trace
    metadata (ledgers, epochs, event counts) equal the JAX package's,
    and each package's ``trace_lint`` passes the other's document."""
    doc = _traced_serial_2fzf(tradar, trace, device="cpu")
    jdoc = _traced_serial_2fzf(jradar, jrimms.trace)
    assert _modeled_events(doc) == _modeled_events(jdoc)
    assert doc["rimms"] == jdoc["rimms"]
    assert trace_lint(jdoc) == [] and jtrace_mod.trace_lint(doc) == []


def test_global_trace_attaches_new_contexts():
    assert global_collector() is None
    with trace() as tc:
        assert global_collector() is tc
        rt, ctx = make_runtime(policy="rimms", accelerators=("gpu0",))
        assert ctx.tracer is tc
    assert global_collector() is None


def test_eviction_instants_under_pressure():
    import numpy as np_
    from repro_torch.core.hete import HeteContext, MemorySpace, hete_malloc
    from repro_torch.core.locations import Location

    acc = Location("device", "acc0")
    with trace() as tc:
        ctx = HeteContext(tracking="flag")
        ctx.register_space(MemorySpace(
            acc, capacity=4096, allocator="nextfit",
            ingest=lambda a: a.copy(), egress=lambda a: np_.asarray(a),
        ))
        for _ in range(4):
            hd = hete_malloc((512,), np_.float32, context=ctx)
            v = ctx.ensure(hd, acc)
            ctx.mark_written(hd, acc, v + 1.0)
        doc = tc.export()
    assert ctx.ledger.total_evictions > 0
    evicts = [e for e in doc["traceEvents"]
              if e.get("ph") == "i" and e.get("name") in ("evict", "spill_to_peer")]
    assert len(evicts) == ctx.ledger.total_evictions
    assert all(e["cat"] == "memory" for e in evicts)
    assert trace_lint(doc) == []


# ---------------------------------------------------------------------------
# session end-to-end
# ---------------------------------------------------------------------------


def test_session_trace_end_to_end(tmp_path):
    sess = make_session(trace=True)
    try:
        submit_2fzf(sess, 64)
        sess.barrier()
        rep = sess.qos_report()
        pct = rep["latency_percentiles"]
        assert pct, "per-client percentiles missing"
        for stats in pct.values():
            assert 0.0 < stats["p50"] <= stats["p95"] <= stats["p99"]
            assert stats["count"] > 0
        assert rep["metrics"]["submits"]["value"] == 4
        sess.close()
        path = tmp_path / "session.json"
        doc = sess.export_trace(str(path))
        assert path.exists()
        assert trace_lint(str(path)) == []
        cats = {e.get("cat") for e in doc["traceEvents"]}
        # full lifecycle: submit -> qos -> stage -> compute -> transfer
        assert {"submit", "qos", "stage", "compute", "transfer"} <= cats
        tenant_tracks = [
            e for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"
            and "tenant:" in e["args"]["name"]
        ]
        assert tenant_tracks
    finally:
        sess.runtime.close()


def test_session_export_without_tracer_raises():
    sess = make_session()
    try:
        submit_2fzf(sess, 64)
        sess.barrier()
        try:
            sess.export_trace()
            raise AssertionError("expected RuntimeError")
        except RuntimeError:
            pass
    finally:
        sess.close()
        sess.runtime.close()


def test_trace_reexported_through_api():
    assert rimms.trace is trace
    assert rimms.trace_lint is trace_lint


# ---------------------------------------------------------------------------
# trace_lint negative cases
# ---------------------------------------------------------------------------


def _doc(events, rimms_meta=None):
    return {"traceEvents": events, "rimms": rimms_meta or {}}


def _lint_both(doc):
    """The port's lint violations, held equal to the JAX package's."""
    got = trace_lint(doc)
    assert got == jtrace_mod.trace_lint(doc)
    return got


def test_lint_flags_negative_duration():
    doc = _doc([{"ph": "X", "name": "bad", "cat": "compute",
                 "pid": 1, "tid": 1, "ts": 5.0, "dur": -1.0}])
    assert any("negative duration" in v for v in _lint_both(doc))


def test_lint_flags_overlapping_compute_spans():
    doc = _doc([
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 1,
         "args": {"name": "run0/pe:gpu0"}},
        {"ph": "X", "name": "a", "cat": "compute", "pid": 2, "tid": 1,
         "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "b", "cat": "compute", "pid": 2, "tid": 1,
         "ts": 5.0, "dur": 10.0},
    ])
    assert any("overlap" in v for v in _lint_both(doc))
    # stage spans may overlap (prefetch/double-buffering): not flagged
    doc_stage = _doc([
        {"ph": "X", "name": "a", "cat": "stage", "pid": 2, "tid": 1,
         "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "b", "cat": "stage", "pid": 2, "tid": 1,
         "ts": 5.0, "dur": 10.0},
    ])
    assert _lint_both(doc_stage) == []


def test_lint_flags_ledger_mismatch():
    meta = {"ledgers": {"ctx0": {"per_link": {
        "host->gpu0": {"copies": 2, "bytes": 256, "modeled_s": 0.0}},
        "bytes_moved": 256}}}
    # only one traced copy of 128 B against a ledger claiming 2/256
    doc = _doc([
        {"ph": "i", "name": "copy", "cat": "transfer", "pid": 1, "tid": 1,
         "ts": 0.0, "s": "t",
         "args": {"ctx": "ctx0", "src": "host", "dst": "gpu0",
                  "nbytes": 128, "epoch": 0}},
    ], meta)
    assert any("conservation" in v for v in _lint_both(doc))


def test_lint_flags_compute_before_staging_done():
    doc = _doc([
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 1,
         "args": {"name": "run0/pe:gpu0:stage"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 2,
         "args": {"name": "run0/pe:gpu0"}},
        {"ph": "X", "name": "t", "cat": "stage", "pid": 2, "tid": 1,
         "ts": 0.0, "dur": 10.0, "args": {"node": 0}},
        {"ph": "X", "name": "t", "cat": "compute", "pid": 2, "tid": 2,
         "ts": 5.0, "dur": 10.0, "args": {"node": 0}},
    ])
    assert any("causality" in v for v in _lint_both(doc))


def test_lint_conservation_nets_out_preattach_baseline():
    rt, ctx = make_runtime(policy="rimms", accelerators=("gpu0",))
    _, tasks = build_2fzf(ctx, 64, pins=("gpu0",) * 4)
    rt.run(tasks)  # untraced copies accumulate first
    with trace(context=ctx) as tc:
        _, tasks2 = build_2fzf(ctx, 64, pins=("gpu0",) * 4, seed=1)
        rt.run(tasks2)
        assert trace_lint(tc.export()) == []


def test_lint_conservation_across_ledger_reset():
    rt, ctx = make_runtime(policy="rimms", accelerators=("gpu0",))
    with trace(context=ctx) as tc:
        _, tasks = build_2fzf(ctx, 64, pins=("gpu0",) * 4)
        rt.run(tasks)
        ctx.ledger.reset()  # opens a fresh conservation epoch
        _, tasks2 = build_2fzf(ctx, 64, pins=("gpu0",) * 4, seed=1)
        rt.run(tasks2)
        assert trace_lint(tc.export()) == []


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_histogram_percentiles_match_numpy_within_bucket_error():
    rng = np.random.default_rng(7)
    xs = rng.lognormal(mean=-8.0, sigma=1.5, size=5000)
    h = Histogram("lat")
    for x in xs:
        h.record(float(x))
    for q in (50, 95, 99):
        got = h.percentile(q)
        want = float(np.percentile(xs, q))
        assert abs(got - want) / want < 0.03, (q, got, want)
    assert h.count == len(xs)
    assert abs(h.mean - xs.mean()) / xs.mean() < 1e-9


@pytest.mark.parametrize("dist", ["lognormal", "edges"])
def test_histogram_percentiles_equal_reference(dist):
    """Both packages' histograms fed the same samples: every percentile,
    the mean and the serialised state are equal."""
    rng = np.random.default_rng(23)
    xs = (rng.lognormal(mean=-6.0, sigma=2.0, size=3000)
          if dist == "lognormal" else
          np.array([0.0, -1.0, 1e-12, 4.2, 4.2, 1e6, 2.0 ** -30]))
    h, jh = Histogram("lat"), jtrace_mod.Histogram("lat")
    for x in xs:
        h.record(float(x))
        jh.record(float(x))
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert h.percentile(q) == jh.percentile(q), q
    assert (h.count, h.mean, h.min, h.max) == (jh.count, jh.mean, jh.min,
                                               jh.max)
    assert h.to_state() == jh.to_state()


def test_histogram_edge_cases():
    h = Histogram()
    # empty histogram: no samples -> percentile is None, not a raise
    assert h.percentile(50) is None and h.mean == 0.0
    h.record(0.0)
    h.record(-1.0)
    assert h.percentile(99) == 0.0  # non-positive values -> zero bucket
    h2 = Histogram()
    h2.record(4.2)
    assert h2.percentile(50) == 4.2  # single sample clamps to min/max


def test_metrics_registry_create_or_get_and_snapshot():
    reg = MetricsRegistry()
    reg.counter("a").inc(3)
    assert reg.counter("a").value == 3  # same instrument back
    reg.gauge("g").set(1.5)
    reg.histogram("h").record(2.0)
    try:
        reg.gauge("a")
        raise AssertionError("expected TypeError")
    except TypeError:
        pass
    snap = reg.snapshot()
    assert snap["a"] == {"type": "counter", "value": 3}
    assert snap["g"]["value"] == 1.5
    assert snap["h"]["count"] == 1
    assert reg.histograms() == [("h", reg.histogram("h"))]
    jreg = jtrace_mod.MetricsRegistry()
    jreg.counter("a").inc(3)
    jreg.gauge("g").set(1.5)
    jreg.histogram("h").record(2.0)
    assert snap == jreg.snapshot()
    assert reg.state() == jreg.state()
