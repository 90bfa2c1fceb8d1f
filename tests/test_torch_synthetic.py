"""The port's fork-join workloads (``apps/synthetic.py``) and elementwise
ops (``apps/elemwise.py``) against the JAX package's.

Both packages build the same DAGs from the same seed and run them with
``scheduler="round_robin"`` (placements from deterministic priors only),
serially and through the graph executor.  Ledger copies, bytes per
(src, dst) pair, placements and the modeled makespan must be exactly
equal; outputs agree within ``fft_tol`` of the FFT kernels' tests,
relative to the output's largest magnitude (the JAX side runs XLA's
``jnp.fft`` on its device PEs, the port's CPU side the plain Stockham
loop).
"""

import math

import numpy as np
import pytest
import torch

import repro.apps.elemwise  # noqa: F401  registers the reference's ops
import repro.apps.radar as jradar
import repro.apps.synthetic as jsyn
import repro_torch.apps.elemwise as telem
import repro_torch.apps.radar as tradar
import repro_torch.apps.synthetic as tsyn
from repro.core.api import Session as JSession
from repro.core.hete import hete_sync as jsync
from repro_torch.core.api import Session as TSession
from repro_torch.core.hete import hete_sync as tsync

torch.set_num_threads(1)


def fft_tol(n):
    # tests/test_kernels.py's tolerances for one transform of n
    rtol = 3e-3 if n >= 2048 else 5e-4
    return rtol, rtol * math.sqrt(n)


def assert_close_to_max(got, want, n):
    rtol, atol = fft_tol(n)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - want)))
    assert err <= atol + rtol * float(np.max(np.abs(want))), err


WORKLOADS = {
    "forkjoin-4x256-d2": (lambda m, c: m.build_fork_join(
        c, ways=4, n=256, depth=2, seed=3), 256),
    "forkjoin-8x256-d2": (lambda m, c: m.build_fork_join(
        c, ways=8, n=256, depth=2, seed=3), 256),
    "forkjoin-2x512-d3": (lambda m, c: m.build_fork_join(
        c, ways=2, n=512, depth=3, seed=4), 512),
    "forkjoin-1x128-d1": (lambda m, c: m.build_fork_join(
        c, ways=1, n=128, depth=1), 128),
    "diamonds-3x128": (lambda m, c: m.build_diamonds(c, count=3, n=128,
                                                     seed=5), 128),
}


def _outs(bufs):
    return bufs["outs"] if "outs" in bufs else [bufs["out"]]


def _run(app, syn, name, policy, mode, n_cpu, device_kw, sync):
    build, _ = WORKLOADS[name]
    rt, ctx = app.make_runtime(policy=policy, scheduler="round_robin",
                               n_cpu=n_cpu, accelerators=("gpu0", "gpu1"),
                               **device_kw)
    bufs, tasks = build(syn, ctx)
    (rt._run_impl if mode == "serial" else rt._run_graph_impl)(tasks)
    makespan = rt.last_makespan_model
    outs = [np.array(sync(hd, context=ctx)) for hd in _outs(bufs)]
    snap = ctx.ledger.snapshot()
    log = list(rt.task_log)
    rt.close()
    return snap, log, makespan, outs


# Serial runs place deterministically on any platform.  The graph
# executor's round robin places in dispatch order, which can follow the
# worker threads' timing: the JAX package's own graph runs give more than
# one makespan from run to run with a cpu PE beside the two accelerators,
# and for the 2-way, depth-3 fork-join under the reference policy.  The
# graph cases are the rest, bench_graph's gate among them (two
# accelerators, fork-joins of 4 and 8 ways at depth 2).
CASES = ([(name, mode, n_cpu) for name in WORKLOADS
          for mode, n_cpu in (("serial", 0), ("serial", 1))]
         + [(name, "graph", 0) for name in WORKLOADS
            if name != "forkjoin-2x512-d3"])


@pytest.mark.parametrize("policy", ["reference", "rimms"])
@pytest.mark.parametrize("name,mode,n_cpu", CASES)
def test_workload_matches_jax(name, mode, n_cpu, policy):
    jsnap, jlog, jms, jouts = _run(jradar, jsyn, name, policy, mode, n_cpu,
                                   {}, jsync)
    tsnap, tlog, tms, touts = _run(tradar, tsyn, name, policy, mode, n_cpu,
                                   {"device": "cpu"}, tsync)
    assert tsnap["by_pair"] == jsnap["by_pair"]
    assert tsnap["total_copies"] == jsnap["total_copies"]
    assert tsnap["total_bytes"] == jsnap["total_bytes"]
    assert tsnap["per_link"] == jsnap["per_link"]
    # the graph executor logs tasks as its workers finish them: the same
    # placements, in an order that depends on the threads
    assert (tlog if mode == "serial" else sorted(tlog)) == (
        jlog if mode == "serial" else sorted(jlog))
    assert tms == jms
    n = WORKLOADS[name][1]
    for got, want in zip(touts, jouts, strict=True):
        assert_close_to_max(got, want, n)


def test_fork_join_graph_equals_serial_bitwise():
    """The graph executor changes nothing but the schedule: the same
    build gives the same bits and copies serially and as a graph."""
    serial = _run(tradar, tsyn, "forkjoin-4x256-d2", "rimms", "serial", 0,
                  {"device": "cpu"}, tsync)
    graph = _run(tradar, tsyn, "forkjoin-4x256-d2", "rimms", "graph", 0,
                 {"device": "cpu"}, tsync)
    assert serial[0]["by_pair"] == graph[0]["by_pair"]
    assert graph[2] < serial[2]  # two accelerators overlap the branches
    for a, b in zip(serial[3], graph[3], strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("ways", [3, 0, 6])
def test_fork_join_rejects_ways_not_a_power_of_two(ways):
    rt, ctx = tradar.make_runtime(policy="rimms", n_cpu=0,
                                  accelerators=("gpu0",), device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        tsyn.build_fork_join(ctx, ways=ways, n=64)
    rt.close()


def _session_fork_join(app, syn, session_cls, device_kw, sync_out):
    with app.make_session(policy="rimms", scheduler="round_robin", n_cpu=0,
                          accelerators=("gpu0", "gpu1"), **device_kw) as s:
        futs = syn.submit_fork_join(s, ways=4, n=256, depth=2, seed=9)
        out = np.array(futs["out"].result())
        by_pair = s.ledger.snapshot()["by_pair"]
        log = list(s.runtime.task_log)
    s.runtime.close()
    return out, by_pair, log


def test_submit_fork_join_matches_jax_and_batch():
    """The session build streams the same DAG: the same ledger and
    placements as the JAX package's, and the same bits as the port's
    batch ``run_graph`` of :func:`build_fork_join` on the same seed."""
    tout, tpair, tlog = _session_fork_join(tradar, tsyn, TSession,
                                           {"device": "cpu"}, None)
    jout, jpair, jlog = _session_fork_join(jradar, jsyn, JSession, {}, None)
    assert tpair == jpair and sorted(tlog) == sorted(jlog)
    assert_close_to_max(tout, jout, 256)
    rt, ctx = tradar.make_runtime(policy="rimms", scheduler="round_robin",
                                  n_cpu=0, accelerators=("gpu0", "gpu1"),
                                  device="cpu")
    bufs, tasks = tsyn.build_fork_join(ctx, ways=4, n=256, depth=2, seed=9)
    rt._run_graph_impl(tasks)
    assert np.array_equal(np.array(tsync(bufs["out"], context=ctx)), tout)
    assert ctx.ledger.snapshot()["by_pair"] == tpair
    rt.close()


# ---------------------------------------------------------- elemwise ----
def _elem_session(cls, device_kw):
    return cls.emulated(policy="rimms", scheduler="round_robin", n_cpu=1,
                        accelerators=("gpu0",), **device_kw)


def _elem_chain(cls, device_kw, pins, dtype):
    """scale → axpy → square → csum, each op pinned as ``pins`` says;
    returns every op's output."""
    s = _elem_session(cls, device_kw)
    try:
        rng = np.random.default_rng(11)
        a = s.malloc((257,), dtype)
        b = s.malloc((257,), dtype)
        a.data[:] = rng.normal(size=257).astype(dtype)
        b.data[:] = rng.normal(size=257).astype(dtype)
        x = s.submit("scale", [a], factor=3.0, pin=pins[0])
        y = s.submit("axpy", [x, b], alpha=-0.7, pin=pins[1])
        z = s.submit("square", [y], pin=pins[2])
        c = s.submit("csum", [z], pin=pins[3])
        p = s.submit("snooze", [z], seconds=0.0, pin=pins[0])
        return [np.array(f.result(timeout=120)) for f in (x, y, z, c, p)]
    finally:
        s.close()
        s.runtime.close()


PINS = {"gpu": ("gpu0",) * 4, "cpu": ("cpu0",) * 4,
        "mixed": ("gpu0", "cpu0", "gpu0", "cpu0")}


@pytest.mark.parametrize("pins", list(PINS))
def test_elemwise_ops_match_reference(pins):
    """scale, axpy, square and snooze give the reference's bits on every
    PE kind (float32: the reference's device spaces hold JAX arrays, which
    keep float32); csum (float64) agrees to 1e-12 relative (a device scan
    may sum in another order than numpy's sequential cumsum)."""
    pins = PINS[pins]
    got = _elem_chain(TSession, {"device": "cpu"}, pins, np.float32)
    want = _elem_chain(JSession, {}, pins, np.float32)
    for name, g, w in zip(("scale", "axpy", "square"), got[:3], want[:3]):
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name
    assert got[3].dtype == np.float64 == want[3].dtype
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12, atol=1e-12)
    assert np.array_equal(got[4], got[2])  # snooze passes a copy through


def test_elemwise_float64_on_device_kinds_keeps_numpy_bits():
    """Float64 buffers stay float64 on the port's device PEs (torch
    tensors), so every PE kind gives numpy's float64 bits -- the cpu
    PE's, in the port and in the reference alike.  (The reference's
    device PEs compute float64 buffers in float32: ``jax.device_put``
    without x64.)"""
    cpu = _elem_chain(TSession, {"device": "cpu"}, PINS["cpu"], np.float64)
    ref_cpu = _elem_chain(JSession, {}, PINS["cpu"], np.float64)
    for pins in ("gpu", "mixed"):
        got = _elem_chain(TSession, {"device": "cpu"}, PINS[pins],
                          np.float64)
        for g, c, r in zip(got[:3], cpu[:3], ref_cpu[:3]):
            assert g.dtype == np.float64
            assert np.array_equal(g, c) and np.array_equal(c, r)
        np.testing.assert_allclose(got[3], ref_cpu[3], rtol=1e-12,
                                   atol=1e-12)


def test_elemwise_device_variants_take_tensors():
    """On an accelerator kind the ops take the PE's tensors and return a
    tensor on the same device (np.asarray of a CUDA tensor would raise);
    the cpu variants stay numpy."""
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    y = torch.ones(2, 3, dtype=torch.float64)
    for fn, args, kw in ((telem.scale_device, [x], {"factor": 2.0}),
                         (telem.axpy_device, [x, y], {"alpha": 0.5}),
                         (telem.square_device, [x], {}),
                         (telem.csum_device, [x], {}),
                         (telem.snooze_device, [x], {"seconds": 0.0})):
        out = fn(args, **kw)
        assert isinstance(out, torch.Tensor) and out.device == x.device
        assert out.data_ptr() != x.data_ptr()
    assert isinstance(telem.scale([x.numpy()]), np.ndarray)
    np.testing.assert_array_equal(telem.csum_device([x]).numpy(),
                                  telem.csum([x.numpy()]))


def test_boom_fails_on_every_kind():
    s = _elem_session(TSession, {"device": "cpu"})
    try:
        a = s.malloc((8,), np.float64)
        for pe in ("cpu0", "gpu0"):
            with pytest.raises(ValueError, match="boom"):
                s.submit("boom", [a], pin=pe).result(timeout=60)
    finally:
        s.close()
        s.runtime.close()
