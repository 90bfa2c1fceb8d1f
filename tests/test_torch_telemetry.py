"""The port's continuous telemetry against the reference
(``tests/test_telemetry.py``).

Every case of the reference's telemetry tests runs here on the port,
with accelerator spaces on CPU tensors (``device="cpu"``): divergence
monitor, histogram merge, sampler lifecycle, Prometheus exposition, SLO
burn rates, registry state merges, the worker-span lint check and the
profile CLI (``repro_torch.profile``), and the process backend's
workers merging their metrics into the session registry.  Where a
value is computed, the JAX package computes it too from the same inputs
and the two must be equal: ``metrics_text`` of registries fed the same
samples, merged histogram and registry states, ``DivergenceMonitor``
tables, shape buckets and SLO evaluations.
"""

import importlib
import json
import math
import threading
import urllib.request
import warnings

import numpy as np
import pytest

import torch

from repro.core import telemetry as jtelemetry
from repro_torch.apps import radar as tradar
from repro_torch.apps.radar import submit_2fzf
from repro_torch.core import telemetry
from repro_torch.core.telemetry import (
    DivergenceMonitor,
    Sampler,
    metrics_text,
    serve_metrics,
    shape_bucket,
    slo_eval,
)
from repro_torch.core.trace import Histogram, MetricsRegistry, trace_lint

# the module (``repro.core`` re-exports its ``trace`` function by that name)
jtrace_mod = importlib.import_module("repro.core.trace")

torch.set_num_threads(1)


def make_session(**kw):
    """The port's radar session with accelerator spaces on CPU tensors."""
    return tradar.make_session(device="cpu", **kw)


# ---------------------------------------------------------------------------
# Histogram.merge
# ---------------------------------------------------------------------------


def test_histogram_merge_empty():
    a, b = Histogram("a"), Histogram("b")
    a.merge(b)
    assert a.count == 0 and a.percentile(50) is None
    b.record(3.0)
    a.merge(b)
    assert a.count == 1 and a.percentile(50) == 3.0
    # merging an empty into a populated one changes nothing
    before = a.to_state()
    a.merge(Histogram("c"))
    assert a.to_state() == before


def test_histogram_merge_single_sample():
    a, b = Histogram(), Histogram()
    a.record(1.0)
    b.record(100.0)
    a.merge(b)
    assert a.count == 2
    assert a.min == 1.0 and a.max == 100.0
    assert a.sum == 101.0
    assert a.percentile(50) is not None


def test_histogram_merge_associative_across_bucket_boundaries():
    rng = np.random.default_rng(11)
    xs = rng.lognormal(mean=-4.0, sigma=2.0, size=900)  # spans many octaves
    parts = [Histogram(), Histogram(), Histogram()]
    for i, x in enumerate(xs):
        parts[i % 3].record(float(x))

    def state(h):
        s = h.to_state()
        s.pop("name")
        # float summation order differs between merge orders; compare
        # the running sum to tolerance, everything else exactly
        assert abs(s.pop("sum") - xs.sum()) < 1e-9
        return s

    # (a + b) + c == a + (b + c) == single histogram of all samples
    ab_c = Histogram().merge(parts[0]).merge(parts[1]).merge(parts[2])
    bc = Histogram().merge(parts[1]).merge(parts[2])
    a_bc = Histogram().merge(parts[0]).merge(bc)
    direct = Histogram()
    for x in xs:
        direct.record(float(x))
    assert state(ab_c) == state(a_bc) == state(direct)
    for q in (50, 95, 99):
        assert ab_c.percentile(q) == direct.percentile(q)


def test_histogram_state_roundtrip_through_json():
    h = Histogram("lat")
    for v in (0.0, 1e-6, 0.5, 3.0, 4096.0):
        h.record(v)
    state = json.loads(json.dumps(h.to_state()))
    back = Histogram.from_state(state)
    assert back.count == h.count and back.sum == h.sum
    assert back.percentile(95) == h.percentile(95)


# ---------------------------------------------------------------------------
# MetricsRegistry state/merge (cross-process aggregation)
# ---------------------------------------------------------------------------


def test_registry_state_merge_counters_and_histograms():
    a = MetricsRegistry()
    a.counter("worker/gpu0/tasks").inc(3)
    a.histogram("worker/gpu0/kernel_s").record(0.5)
    a.gauge("g").set(7.0)  # gauges deliberately excluded from state()
    state = json.loads(json.dumps(a.state()))
    assert "g" not in state["counters"] and "g" not in state["histograms"]

    parent = MetricsRegistry()
    parent.counter("worker/gpu0/tasks").inc(2)
    parent.merge_state(state)
    parent.merge_state({"counters": {}, "histograms": {}})  # empty is fine
    assert parent.counter("worker/gpu0/tasks").value == 5
    assert parent.histogram("worker/gpu0/kernel_s").count == 1


# ---------------------------------------------------------------------------
# DivergenceMonitor
# ---------------------------------------------------------------------------


def test_shape_bucket_labels():
    assert shape_bucket(0) == "0B"
    assert shape_bucket(1) == "<=1B"
    assert shape_bucket(65_536) == "<=64KiB"
    assert shape_bucket(65_537) == "<=128KiB"


def test_divergence_observe_table_and_skips():
    mon = DivergenceMonitor(register=False)
    for _ in range(10):
        mon.observe("compute", "fft", "gpu", 1 << 16, 2e-3, 1e-3)
    mon.observe("compute", "fft", "gpu", 1 << 16, 0.0, 1e-3)  # skipped
    mon.observe("compute", "fft", "gpu", 1 << 16, 1e-3, 0.0)  # skipped
    table = mon.table()
    cell = table["compute/fft/gpu/<=64KiB"]
    assert cell["count"] == 10 and cell["skipped"] == 2
    assert abs(cell["ema_ratio"] - 2.0) < 1e-9
    assert abs(cell["mean_ratio"] - 2.0) < 1e-9
    assert cell["p50_ratio"] is not None and cell["p50_ratio"] > 0


def test_divergence_merge_and_json_roundtrip(tmp_path):
    a = DivergenceMonitor(register=False)
    b = DivergenceMonitor(register=False)
    for _ in range(4):
        a.observe("compute", "fft", "gpu", 1024, 1.5e-3, 1e-3)
        b.observe("compute", "fft", "gpu", 1024, 3e-3, 1e-3)
        b.observe("stage", "zip", "cpu", 2048, 1e-4, 2e-4)
    merged = DivergenceMonitor(register=False)
    merged.merge(a.state())
    merged.merge(b.state())
    t = merged.table()
    assert t["compute/fft/gpu/<=1KiB"]["count"] == 8
    assert t["stage/zip/cpu/<=2KiB"]["count"] == 4
    # count-weighted EMA blend lands between the two monitors' EMAs
    assert 1.5 < t["compute/fft/gpu/<=1KiB"]["ema_ratio"] < 3.0

    # The raw-JSON path is deprecated in favor of calibration
    # tables: exactly one DeprecationWarning per process, then silence.
    path = tmp_path / "divergence.json"
    telemetry._divergence_json_warned = False
    with pytest.warns(DeprecationWarning, match="calibration"):
        merged.save_json(str(path))
    doc = json.loads(path.read_text())
    assert doc["format"] == "rimms-divergence-v1"
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # second call must stay quiet
        back = DivergenceMonitor.load_json(str(path))
    assert back.table() == t


def test_divergence_serial_scopes_aggregation():
    mark = telemetry.divergence_serial()
    mon = DivergenceMonitor()  # registered
    mon.observe("compute", "op", "cpu", 64, 1e-3, 1e-3)
    agg = telemetry.aggregate_divergence(since=mark)
    assert "compute/op/cpu/<=64B" in agg.table()
    # a later mark excludes it
    assert telemetry.aggregate_divergence(
        since=telemetry.divergence_serial()).table() == {}


def test_runtime_populates_divergence_for_compute_and_stage():
    session = make_session(n_cpu=1, accelerators=("gpu0",))
    try:
        out = submit_2fzf(session, 256, seed=3)["out"]
        out.result(timeout=120)
    finally:
        session.close()
        rt = session.runtime
        table = rt.divergence.table()
        rt.close()
    kinds = {c["kind"] for c in table.values()}
    assert "compute" in kinds and "stage" in kinds
    compute = [c for c in table.values()
               if c["kind"] == "compute" and c["count"] > 0]
    assert compute, table
    assert all(math.isfinite(c["ema_ratio"]) and c["ema_ratio"] > 0
               for c in compute)
    # qos_report surfaces the same table
    # (report built before close in normal use; table is identical)


def test_qos_report_has_divergence_section():
    session = make_session(n_cpu=1, accelerators=("gpu0",))
    try:
        submit_2fzf(session, 128, seed=1)["out"].result(timeout=120)
        session.barrier()
        rep = session.qos_report()
        assert isinstance(rep["divergence"], dict)
        assert rep["slo"] == {}  # no objectives declared
    finally:
        session.close()
        session.runtime.close()


# ---------------------------------------------------------------------------
# Sampler lifecycle
# ---------------------------------------------------------------------------


def _make_session(**kw):
    return make_session(n_cpu=1, accelerators=("gpu0",), **kw)


def test_sampler_manual_tick_deterministic_and_bounded():
    session = _make_session()
    try:
        sampler = session.start_sampler(period=0.0, max_samples=8)
        assert not sampler.running  # manual mode: no thread
        for _ in range(20):
            s = sampler.tick()
            assert s is not None
        assert sampler.ticks == 20
        assert len(sampler.samples) == 8  # bounded ring
        seqs = [s["seq"] for s in sampler.samples]
        assert seqs == list(range(13, 21))  # oldest evicted, in order
        sample = sampler.samples[-1]
        gauges = sample["gauges"]
        assert any(k.startswith("pe_queue_depth/") for k in gauges)
        assert any(k.startswith("pe_busy/") for k in gauges)
        assert any(k.startswith("arena_free_bytes/") for k in gauges)
        assert any(k.startswith("arena_used_bytes/") for k in gauges)
        assert any(k.startswith("arena_pinned_bytes/") for k in gauges)
        assert "pressure_evictions" in gauges
        assert any(k.startswith("tenant_window_occupancy/")
                   for k in gauges) or not session.qos.snapshot()["clients"]
        # gauges mirrored into the session registry
        snap = session.metrics.snapshot()
        for name in gauges:
            assert snap[name]["value"] == gauges[name]
    finally:
        session.close()
        session.runtime.close()


def test_sampler_stops_with_session_close():
    session = _make_session(sampler_period=0.005)
    sampler = session.sampler
    assert sampler is not None and sampler.running
    submit_2fzf(session, 128, seed=2)["out"].result(timeout=120)
    session.close()
    assert not sampler.running
    n = sampler.ticks
    assert sampler.tick() is None  # no samples after close
    assert sampler.ticks == n
    session.runtime.close()


def test_sampler_background_thread_ticks_and_ring_is_bounded():
    session = _make_session()
    try:
        sampler = session.start_sampler(period=0.001, max_samples=16)
        assert sampler.running
        deadline = threading.Event()
        for _ in range(200):
            if sampler.ticks >= 20:
                break
            deadline.wait(0.01)
        assert sampler.ticks >= 20
        assert len(sampler.samples) <= 16
    finally:
        session.close()
        session.runtime.close()
    assert not sampler.running


def test_sampler_rejects_bad_params():
    session = _make_session()
    try:
        for kw in ({"period": -1.0}, {"max_samples": 0}):
            try:
                Sampler(session, **kw)
                raise AssertionError(f"expected ValueError for {kw}")
            except ValueError:
                pass
    finally:
        session.close()
        session.runtime.close()


# ---------------------------------------------------------------------------
# Prometheus exposition + HTTP endpoint
# ---------------------------------------------------------------------------


def test_metrics_text_format():
    reg = MetricsRegistry()
    reg.counter("copies/host->gpu0").inc(4)
    reg.gauge("arena_free_bytes/gpu0").set(1024.0)
    reg.histogram("latency_model_s/clientA").record(0.5)
    reg.histogram("latency_model_s/clientA").record(2.0)
    text = metrics_text(reg)
    assert text.endswith("\n")
    lines = text.splitlines()
    assert "# TYPE rimms_copies_total counter" in lines
    assert 'rimms_copies_total{key="host->gpu0"} 4' in lines
    assert "# TYPE rimms_arena_free_bytes gauge" in lines
    assert 'rimms_arena_free_bytes{key="gpu0"} 1024.0' in lines
    assert "# TYPE rimms_latency_model_s summary" in lines
    assert any(l.startswith('rimms_latency_model_s{key="clientA",'
                            'quantile="0.5"}') for l in lines)
    assert 'rimms_latency_model_s_sum{key="clientA"} 2.5' in lines
    assert 'rimms_latency_model_s_count{key="clientA"} 2' in lines
    # deterministic
    assert text == metrics_text(reg)
    # empty-histogram summaries render without quantile lines
    reg2 = MetricsRegistry()
    reg2.histogram("h")
    t2 = metrics_text(reg2)
    assert "quantile" not in t2 and "rimms_h_count 0" in t2


def test_serve_metrics_http_endpoint():
    reg = MetricsRegistry()
    reg.counter("hits").inc(2)
    server = serve_metrics(reg)
    try:
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            assert resp.status == 200
            assert "version=0.0.4" in resp.headers["Content-Type"]
            body = resp.read().decode()
        assert "rimms_hits_total 2" in body
        bad = server.url.replace("/metrics", "/nope")
        try:
            urllib.request.urlopen(bad, timeout=10)
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        server.close()


def test_session_metrics_text_and_server():
    session = _make_session()
    try:
        session.metrics.counter("submitted").inc()
        text = session.metrics_text()
        assert "rimms_submitted_total 1" in text
        server = session.serve_metrics()
        try:
            with urllib.request.urlopen(server.url, timeout=10) as resp:
                assert "rimms_submitted_total 1" in resp.read().decode()
        finally:
            server.close()
    finally:
        session.close()
        session.runtime.close()


# ---------------------------------------------------------------------------
# SLO burn rates
# ---------------------------------------------------------------------------


def test_slo_eval_math():
    s = slo_eval([0.1] * 98 + [3.0] * 2, 1.0, 0.99)
    assert s["tasks"] == 100 and s["violations"] == 2
    assert abs(s["violation_rate"] - 0.02) < 1e-12
    assert abs(s["burn_rate"] - 2.0) < 1e-9 and s["breached"]
    s2 = slo_eval([0.1], 1.0, 0.99)
    assert s2["violations"] == 0 and not s2["breached"]
    assert slo_eval([], 1.0, 0.99)["burn_rate"] == 0.0
    for bad in ((0.0, 0.99), (1.0, 0.0), (1.0, 1.0)):
        try:
            slo_eval([1.0], *bad)
            raise AssertionError(f"expected ValueError for {bad}")
        except ValueError:
            pass


def test_qos_report_slo_section_and_trace_instants():
    session = _make_session(trace=True)
    try:
        # objective below the 20us modeled launch floor -> every task of
        # this client violates; the loose client never does
        tight = session.client("tight", slo_latency_s=1e-6)
        loose = session.client("loose", slo_latency_s=60.0,
                               slo_target=0.9)
        submit_2fzf(session, 128, seed=5, tag="_t")["out"].result(
            timeout=120)
        f = session.submit("fft", [session.malloc((128,), np.complex64)],
                           client=tight, name="tightfft")
        g = session.submit("fft", [session.malloc((128,), np.complex64)],
                           client=loose, name="loosefft")
        f.result(timeout=120)
        g.result(timeout=120)
        session.barrier()
        rep = session.qos_report()
        slo = rep["slo"]
        assert slo["tight"]["violations"] == slo["tight"]["tasks"] == 1
        assert slo["tight"]["breached"]
        assert slo["loose"]["violations"] == 0
        assert not slo["loose"]["breached"]
        assert slo["loose"]["target"] == 0.9
        assert set(slo) == {"tight", "loose"}
        session.close()
        doc = session.export_trace()
        instants = [e for e in doc["traceEvents"]
                    if e.get("cat") == "slo"]
        assert len(instants) == 1
        ev = instants[0]
        assert ev["name"] == "slo_violation"
        assert ev["args"]["task"] == "tightfft"
        assert ev["args"]["latency_s"] > ev["args"]["objective_s"]
        # divergence table rides in the exported doc too
        assert "divergence" in doc["rimms"]
    finally:
        session.close()
        session.runtime.close()


def test_client_slo_validation():
    session = _make_session()
    try:
        for kw in ({"slo_latency_s": 0.0}, {"slo_latency_s": 1.0,
                                            "slo_target": 1.5}):
            try:
                session.client("bad", **kw)
                raise AssertionError(f"expected ValueError for {kw}")
            except ValueError:
                pass
    finally:
        session.close()
        session.runtime.close()


# ---------------------------------------------------------------------------
# trace_lint worker-span check
# ---------------------------------------------------------------------------


def _worker_doc(*, backend="process", nested=True):
    """A minimal two-track doc: parent compute span + forwarded worker
    span (nested and tagged, unless told otherwise)."""
    w0, w1 = (100.0, 900.0) if nested else (2000.0, 3000.0)
    args = {"backend": backend} if backend else {}
    return {
        "traceEvents": [
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
             "args": {"name": "pe:gpu0"}},
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
             "args": {"name": "pe:gpu0:worker"}},
            {"ph": "X", "name": "t", "cat": "compute", "pid": 1, "tid": 1,
             "ts": 0.0, "dur": 1000.0},
            {"ph": "X", "name": "t", "cat": "compute", "pid": 1, "tid": 2,
             "ts": w0, "dur": w1 - w0, "args": args},
        ],
        "rimms": {"drops": 0, "ledgers": {}},
    }


def test_trace_lint_accepts_nested_tagged_worker_span():
    assert trace_lint(_worker_doc()) == []


def test_trace_lint_flags_untagged_worker_span():
    violations = trace_lint(_worker_doc(backend=None))
    assert any("backend" in v for v in violations)


def test_trace_lint_flags_orphaned_worker_span():
    violations = trace_lint(_worker_doc(nested=False))
    assert any("orphaned worker span" in v for v in violations)


# ---------------------------------------------------------------------------
# profile CLI
# ---------------------------------------------------------------------------


def test_profile_report_over_real_trace(tmp_path, capsys):
    from repro_torch import profile as profile_cli

    session = _make_session(trace=True)
    try:
        submit_2fzf(session, 256, seed=9)["out"].result(timeout=120)
        session.barrier()
        session.close()
        session.context.tracer.set_divergence(
            session.runtime.divergence.table())
        path = tmp_path / "TRACE_t.json"
        session.export_trace(str(path))
    finally:
        session.close()
        session.runtime.close()

    rc = profile_cli.main([str(path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Top ops by wall time" in out
    assert "Top ops by modeled time" in out
    assert "| fft |" in out
    assert "Critical path" in out
    # the 2FZF chain has dependencies -> a multi-task critical path
    assert "tasks," in out
    assert "Wall/modeled divergence" in out
    assert "| compute | " in out


def test_profile_cli_fails_on_malformed_input(tmp_path, capsys):
    from repro_torch import profile as profile_cli

    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    missing = tmp_path / "missing.json"
    assert profile_cli.main([str(bad)]) == 1
    assert profile_cli.main([str(missing)]) == 1
    err = capsys.readouterr().err
    assert "traceEvents" in err


# ---------------------------------------------------------------------------
# the same values from the JAX package
# ---------------------------------------------------------------------------


def _fed_registry(registry_cls, rng_seed=5):
    """A registry fed a fixed mix of counters, gauges and histograms."""
    rng = np.random.default_rng(rng_seed)
    reg = registry_cls()
    reg.counter("copies/host->gpu0").inc(4)
    reg.counter("copies/gpu0->host").inc(2)
    reg.counter("submits").inc(17)
    reg.gauge("arena_free_bytes/gpu0").set(1024.0)
    reg.gauge("pe_busy/gpu1").set(0.375)
    for client in ("A", "B"):
        for x in rng.lognormal(mean=-9.0, sigma=1.0, size=200):
            reg.histogram(f"latency_model_s/{client}").record(float(x))
    reg.histogram("empty")
    return reg


def test_metrics_text_equals_reference():
    """Prometheus exposition of registries fed the same samples is the
    same text in both packages."""
    text = metrics_text(_fed_registry(MetricsRegistry))
    assert text == jtelemetry.metrics_text(
        _fed_registry(jtrace_mod.MetricsRegistry))
    assert "rimms_latency_model_s_count" in text


def test_registry_and_histogram_merges_equal_reference():
    """Merging the same registry states (and the same histogram parts)
    gives the same state and percentiles in both packages, whichever
    package serialised the parts."""
    port = [_fed_registry(MetricsRegistry, s).state() for s in (1, 2, 3)]
    jax_ = [_fed_registry(jtrace_mod.MetricsRegistry, s).state()
            for s in (1, 2, 3)]
    assert port == jax_
    merged, jmerged = MetricsRegistry(), jtrace_mod.MetricsRegistry()
    for state in jax_:
        merged.merge_state(json.loads(json.dumps(state)))
    for state in port:
        jmerged.merge_state(json.loads(json.dumps(state)))
    assert merged.state() == jmerged.state()
    assert merged.snapshot() == jmerged.snapshot()
    h = merged.histogram("latency_model_s/A")
    jh = jmerged.histogram("latency_model_s/A")
    for q in (50, 95, 99):
        assert h.percentile(q) == jh.percentile(q)


def _fed_monitor(monitor_cls):
    rng = np.random.default_rng(13)
    mon = monitor_cls(register=False)
    for k in range(300):
        kind = ("compute", "stage")[k % 2]
        op = ("fft", "zip", "ifft")[k % 3]
        pe = ("gpu", "cpu")[k % 5 == 0]
        nbytes = int(rng.integers(1, 1 << 20))
        wall = float(rng.lognormal(mean=-9.0, sigma=0.5))
        model = float(rng.lognormal(mean=-9.5, sigma=0.3))
        mon.observe(kind, op, pe, nbytes, wall if k % 17 else 0.0, model)
    return mon


def test_divergence_table_equals_reference():
    """Both packages' divergence monitors fed the same observations (a
    few skipped) give the same table, and each merges the other's state
    to the same table."""
    mon = _fed_monitor(DivergenceMonitor)
    jmon = _fed_monitor(jtelemetry.DivergenceMonitor)
    assert mon.table() == jmon.table()
    both = DivergenceMonitor(register=False)
    both.merge(mon.state())
    both.merge(jmon.state())
    jboth = jtelemetry.DivergenceMonitor(register=False)
    jboth.merge(jmon.state())
    jboth.merge(mon.state())
    assert both.table() == jboth.table()


@pytest.mark.parametrize("nbytes", [0, 1, 2, 3, 1023, 1024, 1025, 65_536,
                                    65_537, 1 << 30, (1 << 30) + 1])
def test_shape_bucket_equals_reference(nbytes):
    assert shape_bucket(nbytes) == jtelemetry.shape_bucket(nbytes)


@pytest.mark.parametrize("target", [0.5, 0.9, 0.99, 0.999])
def test_slo_eval_equals_reference(target):
    rng = np.random.default_rng(29)
    lats = list(rng.lognormal(mean=-7.0, sigma=1.2, size=500))
    for objective in (1e-4, 1e-3, 1e-2):
        assert slo_eval(lats, objective, target) == jtelemetry.slo_eval(
            lats, objective, target)


# ---------------------------------------------------------------------------
# process-backend workers merge their metrics into the session registry
# ---------------------------------------------------------------------------


def test_process_workers_merge_metrics_into_session_registry():
    import signal

    def fire(signum, frame):
        raise TimeoutError("worker metrics case exceeded its 180 s deadline")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(180)
    session = make_session(n_cpu=0, accelerators=("gpu0",),
                           backend="process")
    try:
        out = submit_2fzf(session, 256, seed=4, pins=("gpu0",) * 4)[
            "out"].result(timeout=600)
        session.barrier()
        session.close()
        snap = session.metrics.snapshot()
        assert snap["worker/gpu0/tasks"]["value"] == 4  # fft,fft,zip,ifft
        ks = snap["worker/gpu0/kernel_s"]
        assert ks["count"] == 4 and ks["sum"] > 0
        # drain semantics: a second collect adds nothing
        pool = session.runtime._process_pool
        before = session.metrics.counter("worker/gpu0/tasks").value
        assert pool.collect_metrics(session.metrics) >= 1
        assert session.metrics.counter(
            "worker/gpu0/tasks").value == before
        # the same chain in-process: the same bits and the same ledger
        with make_session(n_cpu=0, accelerators=("gpu0",)) as ts:
            tout = submit_2fzf(ts, 256, seed=4, pins=("gpu0",) * 4)[
                "out"].result(timeout=600)
            ts.barrier()
            assert (ts.ledger.snapshot()["by_pair"]
                    == session.ledger.snapshot()["by_pair"])
        ts.runtime.close()
        np.testing.assert_array_equal(np.asarray(out), np.asarray(tout))
    finally:
        session.close()
        session.runtime.close()
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
