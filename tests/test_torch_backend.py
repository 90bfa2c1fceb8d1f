"""The port's process PE-worker backend against the reference
(``tests/test_backend.py``): backend selection, shared-memory host
arenas, thread↔process bit-identity + copy-count parity, worker failure
containment, subprocess lifecycle, platform presets, deprecation of the
batch wrappers, and closed-loop think time in the QoS replay.

Every case of the reference's backend tests runs here on ``repro_torch``
with accelerator spaces on the CPU (``device="cpu"``): under
``backend="process"`` they hold host-format shared-memory copies and
their PEs run in spawned workers, which hand the kernels CPU tensors.
Where a value is computed, the JAX package computes it too and the two
must be equal: the process run's outputs and ledger ``by_pair`` against
the JAX package's process run of the same chain, the QoS-replayed
makespans, and both packages' process smokes of ``bench_graph`` and
``bench_stream`` (modeled gates, copies, bytes, the ``gate_skipped``
rule), which also equal the committed baselines.

A test that spawns workers runs under a deadline of its own
(:func:`deadline`): a hung worker fails that test, not the run.
"""

import functools
import json
import os
import signal
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.apps.elemwise  # noqa: F401  registers the JAX package's ops
import repro_torch.apps.elemwise  # noqa: F401  registers numpy/torch test ops
from repro.core.api import Session as JSession
from repro_torch.core import runtime as runtime_mod
from repro_torch.core.api import Session
from repro_torch.core.pworker import WORKER_TORCH_THREADS, ProcessWorker, WorkerDied
from repro_torch.core.qos import ClientState, QoSManager
from repro_torch.core.runtime import (
    BACKENDS, platform_names, register_platform, resolve_backend,
)
from repro_torch.core.shm import SharedHostArena, describe_array, resolve_handle

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"


def deadline(seconds):
    """Fail the decorated test with ``TimeoutError`` after ``seconds``
    (SIGALRM in the test's own process)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def fire(signum, frame):
                raise TimeoutError(
                    f"{fn.__name__} exceeded its {seconds} s deadline")

            old = signal.signal(signal.SIGALRM, fire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return run
    return wrap


def _session(backend, session_cls=Session, **kwargs):
    kwargs.setdefault("policy", "rimms")
    kwargs.setdefault("scheduler", "round_robin")
    kwargs.setdefault("n_cpu", 1)
    kwargs.setdefault("accelerators", ("gpu0",))
    if session_cls is Session:
        kwargs.setdefault("device", "cpu")
    return session_cls.emulated(backend=backend, **kwargs)


def _close(session):
    session.close()
    session.runtime.close()


def _run_chain(backend, session_cls=Session):
    """scale→square→csum across cpu0 and gpu0; returns (out, by_pair)."""
    s = _session(backend, session_cls)
    try:
        a = s.malloc((256,), np.float64)
        a.data[:] = np.linspace(-1.0, 1.0, 256)
        b = s.submit("scale", [a], factor=3.0, pin="gpu0")
        c = s.submit("square", [b], pin="cpu0")
        d = s.submit("csum", [c], pin="gpu0")
        out = np.array(d.result(timeout=180))
        return out, s.ledger.snapshot()["by_pair"]
    finally:
        _close(s)


# ---------------------------------------------------------------------------
# backend selection
# ---------------------------------------------------------------------------


def test_resolve_backend_choices():
    assert resolve_backend(None) == "thread"
    assert resolve_backend("thread") == "thread"
    assert resolve_backend("process") == "process"
    assert resolve_backend("auto") in ("thread", "process")


def test_resolve_backend_auto_rule():
    """The reference's rule with torch's device count for JAX's:
    ``process`` on a multi-core host or with more than one CUDA device."""
    multi = (os.cpu_count() or 1) > 1 or torch.cuda.device_count() > 1
    assert resolve_backend("auto") == ("process" if multi else "thread")


def test_unknown_backend_rejected_with_choices():
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("celery")
    with pytest.raises(ValueError) as ei:
        resolve_backend("celery")
    for choice in BACKENDS:
        assert choice in str(ei.value)


def test_session_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend"):
        _session("fork")


def test_session_exposes_backend_and_report():
    s = _session("thread")
    try:
        assert s.backend == "thread"
        assert s.report()["backend"] == "thread"
    finally:
        _close(s)


# ---------------------------------------------------------------------------
# shared-memory host arena
# ---------------------------------------------------------------------------


def test_arena_roundtrip_and_describe():
    arena = SharedHostArena(1 << 16)
    try:
        arr = arena.zeros((32,), np.float64)
        assert arr is not None and not arr.any()
        arr[:] = np.arange(32)
        h = describe_array(arr)
        assert h is not None and h[0] == arena.name
        view = resolve_handle(h)
        assert np.array_equal(view, arr)
        assert not view.flags.writeable
        heap = np.arange(8.0)  # not arena-backed → no handle
        assert describe_array(heap) is None
    finally:
        arena.destroy()


def test_arena_gc_returns_extents():
    arena = SharedHostArena(1 << 16)
    try:
        arr = arena.empty((1024,), np.float64)  # 8 KiB
        assert arr is not None
        used = arena.used_bytes()
        assert used >= 8192
        del arr
        assert arena.used_bytes() < used
    finally:
        arena.destroy()


def test_arena_full_falls_back_to_none():
    arena = SharedHostArena(1 << 12)  # 4 KiB
    try:
        assert arena.zeros((1 << 20,), np.float64) is None
        assert arena.copy_in(np.zeros(1 << 20)) is None
        assert arena.zeros((16,), np.float64) is not None
    finally:
        arena.destroy()
        arena.destroy()  # idempotent


# ---------------------------------------------------------------------------
# thread ↔ process parity (runs on any core count; 1-core is just slow)
# ---------------------------------------------------------------------------


@deadline(240)
def test_process_backend_bit_identical_to_thread():
    out_t, pairs_t = _run_chain("thread")
    out_p, pairs_p = _run_chain("process")
    assert np.array_equal(out_t, out_p)
    assert pairs_t == pairs_p
    # the JAX package's process run of the same chain: the same ledger
    # and, where the arithmetic is one IEEE operation per element
    # (scale, square) followed by a float64 cumulative sum, the same
    # values within the sum's rounding
    jout, jpairs = _run_chain("process", JSession)
    assert pairs_p == jpairs
    np.testing.assert_allclose(out_p, jout, rtol=1e-12, atol=1e-12)


@deadline(180)
def test_process_backend_worker_lifecycle():
    s = _session("process")
    a = s.malloc((64,), np.float64)
    out = s.submit("scale", [a], factor=2.0, pin="gpu0").result(timeout=180)
    assert np.array_equal(np.asarray(out), np.zeros(64))
    pool = s.runtime._process_pool
    assert pool is not None
    pids = pool.pids()
    assert "gpu0" in pids
    assert os.getpid() not in pids.values()
    procs = pool.procs()
    assert all(p.is_alive() for p in procs)
    # a worker runs host payloads only: it never initialises CUDA, and
    # runs torch's CPU ops on its stated thread count
    info = pool.worker("gpu0").metrics_state()["worker"]
    assert info["pid"] == pids["gpu0"]
    assert info["cuda_initialized"] is False
    assert info["torch_threads"] == WORKER_TORCH_THREADS
    _close(s)
    deadline_t = time.monotonic() + 10
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline_t:
        time.sleep(0.05)
    assert not any(p.is_alive() for p in procs), "close() must reap workers"


@deadline(180)
def test_process_backend_kernel_error_propagates():
    s = _session("process")
    try:
        a = s.malloc((8,), np.float64)
        with pytest.raises(RuntimeError, match="boom kernel always fails"):
            s.submit("boom", [a], pin="gpu0").result(timeout=180)
    finally:
        _close(s)


@deadline(180)
def test_process_backend_worker_death_is_clean_error():
    s = _session("process")
    try:
        a = s.malloc((8,), np.float64)
        with pytest.raises(WorkerDied, match="exit code 17"):
            s.submit("die", [a], pin="gpu0").result(timeout=180)
        # the pool replaces the dead worker: later tasks still run
        out = s.submit("scale", [a], factor=1.0, pin="gpu0").result(
            timeout=180)
        assert np.array_equal(np.asarray(out), np.zeros(8))
    finally:
        _close(s)


@deadline(120)
def test_unpicklable_kernel_clear_error():
    w = ProcessWorker("t0")
    try:
        with pytest.raises(RuntimeError, match="module-level kernel"):
            w.ensure_kernel(("nope", "cpu"), lambda ins: ins[0])
    finally:
        w.shutdown()


@pytest.mark.skipif((os.cpu_count() or 1) < 2,
                    reason="overlap needs >1 core")
@deadline(240)
def test_process_backend_overlaps_sleep_kernels():
    s = _session("process", n_cpu=1, accelerators=("gpu0", "gpu1"))
    try:
        bufs = [s.malloc((8,), np.float64) for _ in range(2)]
        for pe, b in zip(("gpu0", "gpu1"), bufs):  # warm both workers
            s.submit("scale", [b], factor=1.0, pin=pe).result(timeout=180)
        t0 = time.perf_counter()
        futs = [s.submit("snooze", [b], seconds=0.4, pin=pe)
                for pe, b in zip(("gpu0", "gpu1"), bufs)]
        for f in futs:
            f.result(timeout=180)
        wall = time.perf_counter() - t0
        assert wall < 0.72, f"no overlap: two 0.4s sleeps took {wall:.2f}s"
    finally:
        _close(s)


@deadline(180)
def test_process_backend_traced_run_lints_clean():
    from repro_torch.core.trace import trace, trace_lint

    s = _session("process")
    try:
        with trace(s.context) as tc:
            a = s.malloc((64,), np.float64)
            out = s.submit("scale", [a], factor=2.0, pin="gpu0").result(
                timeout=180)
            assert np.asarray(out).shape == (64,)
            s.barrier()
        doc = tc.export()
        assert trace_lint(doc) == []
        worker_spans = [
            e for e in doc["traceEvents"]
            if e.get("ph") == "X"
            and (e.get("args") or {}).get("backend") == "process"
        ]
        assert worker_spans, "no forwarded worker spans in trace"
    finally:
        _close(s)


@deadline(240)
def test_process_backend_calibrates_on_workers():
    """``autotune`` under the process backend measures every PE kind on
    its worker (cpu0 and, on the CPU, gpu0) and writes the same cells,
    winners' keys and bit-identity flags as the thread backend."""
    import repro_torch.apps.radar  # noqa: F401  (radar ops + calib inputs)
    from repro_torch.core.autotune import autotune

    tables = {}
    for backend in ("thread", "process"):
        s = _session(backend, n_cpu=1, accelerators=("gpu0",))
        try:
            tables[backend] = autotune(s, nbytes=[1 << 10], k=1, warmup=0,
                                       extra_ops=("zip",))
            if backend == "process":
                assert sorted(s.runtime._process_pool.pids()) == [
                    "cpu0", "gpu0"]
        finally:
            _close(s)
    thread, proc = (tables[b].state() for b in ("thread", "process"))
    assert proc["meta"]["backend"] == "process"

    def cells(state):  # "op/variant/kind/bucket" -> bit-identity flag
        return {k: c.get("identical") for k, c in state["cells"].items()}

    assert cells(proc) == cells(thread)
    assert set(proc["winners"]) == set(thread["winners"])


# ---------------------------------------------------------------------------
# platform presets
# ---------------------------------------------------------------------------


def test_builtin_platforms_registered():
    names = platform_names()
    for preset in ("emulated_soc", "pcie_tree", "nvlink_mesh",
                   "host_bridged_fpga"):
        assert preset in names


def test_session_emulated_platform_shorthand():
    s = Session.emulated("pcie_tree", policy="rimms",
                         accelerators=("gpu0", "gpu1"), device="cpu")
    try:
        assert s.backend == "thread"
    finally:
        _close(s)


def test_unknown_platform_lists_presets():
    with pytest.raises(ValueError, match="unknown platform"):
        Session.emulated("my_quantum_soc", device="cpu")


def test_register_platform_custom_and_duplicate():
    name = "test_soc_custom"
    register_platform(name, arena_bytes=1 << 20, replace=True)
    assert name in platform_names()
    with pytest.raises(ValueError):
        register_platform(name)
    register_platform(name, arena_bytes=2 << 20, replace=True)


# ---------------------------------------------------------------------------
# deprecation of the batch wrappers
# ---------------------------------------------------------------------------


def test_run_wrappers_warn_once(monkeypatch):
    from repro_torch.apps.radar import make_runtime
    from repro_torch.core.runtime import Task

    monkeypatch.setattr(runtime_mod, "_deprecation_warned", False)
    rt, ctx = make_runtime(policy="rimms", n_cpu=1, accelerators=(),
                           device="cpu")
    a = ctx.malloc((16,), np.complex64)
    b = ctx.malloc((16,), np.complex64)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rt.run([Task("fft", [a], [b])])
        rt.run([Task("fft", [a], [b])])
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)
           and "Session" in str(w.message)]
    assert len(dep) == 1, "run() must warn exactly once per process"
    rt.close()


def test_internal_impls_do_not_warn(monkeypatch):
    from repro_torch.apps.radar import make_runtime
    from repro_torch.core.runtime import Task

    monkeypatch.setattr(runtime_mod, "_deprecation_warned", False)
    rt, ctx = make_runtime(policy="rimms", n_cpu=1, accelerators=(),
                           device="cpu")
    a = ctx.malloc((16,), np.complex64)
    b = ctx.malloc((16,), np.complex64)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rt._run_impl([Task("fft", [a], [b])])
        rt._run_graph_impl([Task("fft", [a], [b])])
    assert not [w for w in caught
                if issubclass(w.category, DeprecationWarning)]
    rt.close()


# ---------------------------------------------------------------------------
# closed-loop think time (QoS replay)
# ---------------------------------------------------------------------------


def test_client_state_think_time_validation():
    assert ClientState("c").think_s == 0.0
    assert ClientState("c", think_s=0.25).think_s == 0.25
    with pytest.raises(ValueError):
        ClientState("c", think_s=-1.0)


def test_qos_client_think_time_param():
    qos = QoSManager()
    qos.client("a", think_s=0.5)
    assert qos.params()["clients"]["a"]["think_s"] == 0.5
    qos.client("a", think_s=0.0)
    assert qos.params()["clients"]["a"]["think_s"] == 0.0
    with pytest.raises(ValueError):
        qos.client("b", think_s=-0.1)


def test_session_think_time_stretches_replay():
    """With closed-loop think time a client re-submits only after its
    think delay, so the QoS-replayed makespan grows by ~chains*think_s
    (``report()`` stays QoS-blind; ``qos_report()`` re-enacts
    admission).  The JAX package replays the same makespans."""
    def run(think_s, session_cls=Session):
        s = _session("thread", session_cls, n_cpu=0, accelerators=("gpu0",))
        try:
            cl = s.client("c0", window=1, think_s=think_s)
            for k in range(4):
                a = s.malloc((64,), np.float64)
                cl.submit("scale", [a], factor=2.0, pin="gpu0",
                          name=f"t{k}").result(timeout=180)
            s.barrier()
            return s.qos_report()["makespan_model"]
        finally:
            _close(s)

    base = run(0.0)
    slow = run(0.01)
    assert slow >= base + 0.025, (
        f"think_s=10ms over 4 sequential tasks should stretch the "
        f"QoS-replayed makespan by >=25ms (got {base:.6f} -> {slow:.6f})"
    )
    assert (base, slow) == (run(0.0, JSession), run(0.01, JSession))


# ---------------------------------------------------------------------------
# the process smokes of both packages (bench_graph, bench_stream)
# ---------------------------------------------------------------------------


def _process_smokes(pkg, tmp_path):
    """Both process smokes of one package's benches, as records."""
    if pkg == "port":
        from benchmarks_torch import bench_graph, bench_stream
        kw = {"device": "cpu"}
    else:
        from benchmarks import bench_graph, bench_stream
        kw = {}
    g = tmp_path / f"{pkg}_graph.json"
    s = tmp_path / f"{pkg}_stream.json"
    bench_graph.smoke(str(g), backend="process", **kw)
    bench_stream.run_stream(clients=4, chains=6, n=bench_stream.N_PROCESS,
                            json_path=str(s), smoke=True, backend="process",
                            **kw)
    return json.loads(g.read_text()), json.loads(s.read_text())


def _modeled(rec):
    """A process record's modeled evidence: every gate but the wall,
    and the copy and byte counts of each case."""
    gate = {k: v for k, v in rec["gate"].items()
            if k != "wall_speedup_vs_serial"}
    cases = {case: {k: rec[case][k] for k in ("copies", "bytes",
                                               "makespan_model")
                    if k in rec[case]}
             for case in ("serial", "graph", "stream", "batch_graph")
             if case in rec}
    return gate, cases


@deadline(420)
def test_process_smokes_equal_reference_and_baselines(tmp_path):
    port = _process_smokes("port", tmp_path)
    ref = _process_smokes("jax", tmp_path)
    names = ("BENCH_graph_process.json", "BENCH_stream_process.json")
    for rec, jrec, name in zip(port, ref, names):
        assert rec["backend"] == jrec["backend"] == "process"
        assert rec["params"] == jrec["params"]
        assert _modeled(rec) == _modeled(jrec)
        # the committed baseline's modeled gates, exactly
        base = json.loads((BASELINES / name).read_text())
        assert _modeled(rec)[0] == {k: v for k, v in base["gate"].items()
                                    if k != "wall_speedup_vs_serial"}
        # the same wall-gate rule: gated with >= 4 cores, else skipped
        for r in (rec, jrec):
            assert r["gate_directions"] == {"wall_speedup_vs_serial": "min"}
            assert r["gate_tolerances"] == {"wall_speedup_vs_serial": 0.0}
            if (os.cpu_count() or 1) >= 4:
                assert "wall_speedup_vs_serial" in r["gate"]
                assert "gate_skipped" not in r
            else:
                assert r["gate_skipped"] == ["wall_speedup_vs_serial"]
            assert r["wall_speedup_vs_serial"] > 0
    stream, jstream = port[1], ref[1]
    assert stream["bit_identical_vs_thread"] is True
    assert jstream["bit_identical_vs_thread"] is True
    assert stream["bit_identical"] and stream["copies_match"]
