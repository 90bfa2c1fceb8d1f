"""The port's measured calibration and autotuning against the reference
(``tests/test_calibrate.py``).

Every case of the reference's calibration tests runs here on the port,
with accelerator spaces on CPU tensors (``device="cpu"``): the table's
persistence, merge and the forms ``resolve_calibration`` takes, the
``CostModel``'s measured cell and its fallback, deterministic variant
dispatch from a fixed table, the session's calibration lifecycle, the
tuned variants' bit-identity, autotuning, and calibration on the process
backend with the workers' metrics drained.  Where a value is computed
the JAX package computes it too from the same calls and the two must be
equal: the tables' states and saved documents, merged cells and winners,
modeled costs with and without a table, the variants dispatched and
their outputs, the registry's selections, the skipped ops, the tunables'
search space, and autotuning's cells with their bit-identity flags and
its winners' keys.  Measured times differ between the packages; they are
compared only where a test fixes them.
"""

import json

import numpy as np
import pytest
import torch

import repro.apps.elemwise as jelemwise
from repro.core import api as japi
from repro.core import calibrate as jcal
from repro.core import graph as jgraph
from repro_torch.apps import elemwise
from repro_torch.core.api import OpRegistry, Session
from repro_torch.core.calibrate import (
    DEFAULT_VARIANT, FORMAT, CalibrationTable, calibrate,
    resolve_calibration,
)
from repro_torch.core.graph import CostModel

torch.set_num_threads(1)


# module-level kernels: the process backend ships fns by pickle
# reference, and the registry rejects closures changing between variants
def _double(ins):
    return np.asarray(ins[0]) * 2.0


def _double_alt(ins):
    return (np.asarray(ins[0]) * 2.0) + 0.0


def _make_f64(rng, nbytes):
    return [rng.standard_normal(max(nbytes // 8, 1))]


def _both(build):
    """``build(cls)`` applied to each package's ``CalibrationTable``."""
    return build(CalibrationTable), build(jcal.CalibrationTable)


# ---------------------------------------------------------------------------
# CalibrationTable persistence + merge
# ---------------------------------------------------------------------------


def test_table_save_load_roundtrip(tmp_path):
    def build(cls):
        t = cls()
        t.record("fft", "default", "cpu", 1 << 20, 1e-3)
        t.record("fft", "block64", "cpu", 1 << 20, 5e-4, identical=True)
        t.set_winner("fft", "cpu", 1 << 20, "block64", speedup=2.0,
                     median_s=5e-4)
        t.meta["host"] = "testbox"
        t.divergence = {"cells": {}}
        return t

    t, jt = _both(build)
    path, jpath = tmp_path / "calib.json", tmp_path / "jcalib.json"
    t.save(str(path))
    jt.save(str(jpath))
    doc = json.loads(path.read_text())
    assert doc["format"] == FORMAT == jcal.FORMAT
    assert doc == json.loads(jpath.read_text())

    back = CalibrationTable.load(str(path))
    assert back.state() == t.state() == jt.state()
    assert back.best_variant("fft", "cpu", 1 << 20) == "block64"
    assert back.meta["host"] == "testbox"
    assert back.divergence == {"cells": {}}
    # each package loads the other's file to the same state
    assert (CalibrationTable.load(str(jpath)).state()
            == jcal.CalibrationTable.load(str(path)).state())


def test_table_load_rejects_unknown_format(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"format": "rimms-calib-v999"}))
    for cls in (CalibrationTable, jcal.CalibrationTable):
        with pytest.raises(ValueError, match="format"):
            cls.load(str(path))


def test_table_merge_count_weights_cells_and_keeps_best_winner():
    def build(cls):
        a, b = cls(), cls()
        a.record("zip", "default", "cpu", 4096, 1e-3)
        b.record("zip", "default", "cpu", 4096, 3e-3)
        a.set_winner("zip", "cpu", 4096, "default", speedup=1.0,
                     median_s=1e-3)
        b.set_winner("zip", "cpu", 4096, "fast", speedup=1.5, median_s=2e-3)
        a.merge(b)
        first = (a.cell("zip", "cpu", 4096), a.winner("zip", "cpu", 4096))
        c = cls()
        c.set_winner("zip", "cpu", 4096, "fast", speedup=4.0,
                     median_s=25e-5)
        a.merge(c.state())  # merge accepts a raw state dict too
        return a, first

    (a, (cell, winner)), (ja, (jcell, jwinner)) = _both(build)
    assert cell["count"] == 2
    assert abs(cell["median_s"] - 2e-3) < 1e-12  # count-weighted mean
    # b's winner is SLOWER (2e-3 > 1e-3): the existing winner stays
    assert winner["variant"] == "default"
    assert a.winner("zip", "cpu", 4096)["variant"] == "fast"
    assert (cell, winner) == (jcell, jwinner)
    assert a.state() == ja.state()


def test_resolve_calibration_forms(tmp_path, monkeypatch):
    for resolve, cls in ((resolve_calibration, CalibrationTable),
                         (jcal.resolve_calibration, jcal.CalibrationTable)):
        assert resolve(None) is None
        t = cls()
        assert resolve(t) is t
    path = tmp_path / "c.json"
    t = CalibrationTable()
    t.record("fft", "default", "cpu", 1024, 1e-4)
    t.save(str(path))
    assert len(resolve_calibration(str(path))) == 1
    assert (resolve_calibration(str(path)).state()
            == jcal.resolve_calibration(str(path)).state())
    # "auto": empty table when the env var points nowhere...
    monkeypatch.delenv("RIMMS_CALIBRATION", raising=False)
    assert len(resolve_calibration("auto")) == 0
    assert len(jcal.resolve_calibration("auto")) == 0
    # ...and the file's contents when it does
    monkeypatch.setenv("RIMMS_CALIBRATION", str(path))
    assert len(resolve_calibration("auto")) == 1
    assert (resolve_calibration("auto").state()
            == jcal.resolve_calibration("auto").state())


# ---------------------------------------------------------------------------
# CostModel integration
# ---------------------------------------------------------------------------


def test_cost_model_uses_measured_cell_and_falls_back_on_missing():
    nb = 1 << 20
    t, jt = _both(lambda cls: cls())
    for table in (t, jt):
        table.record("fft", "default", "gpu", nb, 2e-3)
    cm, jcm = CostModel(calibration=t), jgraph.CostModel(calibration=jt)
    # measured bucket: linear interpolation off the measured cell
    measured = cm.prior_estimate("fft", "gpu", nb)
    assert abs(measured - 2e-3) < 1e-9
    # missing bucket (different size class) → the historical prior
    prior = CostModel().prior_estimate("fft", "gpu", 1 << 10)
    assert cm.prior_estimate("fft", "gpu", 1 << 10) == prior
    # missing kind → prior as well
    assert (cm.prior_estimate("fft", "cpu", nb)
            == CostModel().prior_estimate("fft", "cpu", nb))
    # the modeled costs are the JAX package's, with the table and without
    for args in (("fft", "gpu", nb), ("fft", "gpu", 1 << 10),
                 ("fft", "cpu", nb)):
        assert cm.prior_estimate(*args) == jcm.prior_estimate(*args)
        assert (CostModel().prior_estimate(*args)
                == jgraph.CostModel().prior_estimate(*args))
    # detach restores the prior everywhere
    cm.set_calibration(None)
    assert cm.prior_estimate("fft", "gpu", nb) == CostModel().prior_estimate(
        "fft", "gpu", nb)


# ---------------------------------------------------------------------------
# deterministic variant dispatch from a fixed table
# ---------------------------------------------------------------------------


def _variant_session(table, jax_package=False):
    reg = (japi.OpRegistry if jax_package else OpRegistry)()
    reg.register("double", "cpu", _double, calib=_make_f64)
    reg.register("double", "cpu", _double_alt, variant="alt")
    if jax_package:
        return japi.Session.emulated(n_cpu=1, accelerators=(), registry=reg,
                                     calibration=table)
    return Session.emulated(n_cpu=1, accelerators=(), registry=reg,
                            calibration=table, device="cpu")


def _dispatch(table, n, jax_package=False):
    """The variants a session logs for one ``double`` of n float64, and
    its output."""
    session = _variant_session(table, jax_package)
    try:
        x = np.arange(n, dtype=np.float64)
        out = session.submit("double", [x]).result(timeout=60)
        session.barrier()
        return ([v for (o, _k, v) in session.runtime.variant_log
                 if o == "double"], np.asarray(out))
    finally:
        session.close()


def test_runtime_dispatches_winner_variant_from_fixed_table():
    n = 1024  # float64 → 8 KiB bucket

    def build(cls):
        table = cls()
        table.record("double", "default", "cpu", 8 * n, 1e-3)
        table.record("double", "alt", "cpu", 8 * n, 5e-4, identical=True)
        table.set_winner("double", "cpu", 8 * n, "alt", speedup=2.0,
                         median_s=5e-4)
        return table

    table, jtable = _both(build)
    log, out = _dispatch(table, n)
    assert log == ["alt"]
    np.testing.assert_array_equal(out, np.arange(n, dtype=np.float64) * 2.0)
    jlog, jout = _dispatch(jtable, n, jax_package=True)
    assert log == jlog
    np.testing.assert_array_equal(out, jout)


def test_runtime_default_dispatch_without_table_or_winner():
    # no calibration attached → default variant, nothing logged
    assert _dispatch(None, 1024)[0] == [] == _dispatch(None, 1024, True)[0]

    # table attached but winner at a DIFFERENT bucket → default path
    def build(cls):
        table = cls()
        table.set_winner("double", "cpu", 1 << 20, "alt", speedup=2.0,
                         median_s=1e-4)
        return table

    table, jtable = _both(build)
    log, out = _dispatch(table, 1024)
    # the winner lives at a different bucket: default path, no log
    assert log == []
    np.testing.assert_array_equal(out,
                                  np.arange(1024, dtype=np.float64) * 2.0)
    jlog, jout = _dispatch(jtable, 1024, jax_package=True)
    assert jlog == log
    np.testing.assert_array_equal(out, jout)


def test_registry_select_consults_table():
    for reg_cls, table_cls in ((OpRegistry, CalibrationTable),
                               (japi.OpRegistry, jcal.CalibrationTable)):
        reg = reg_cls()
        reg.register("double", "cpu", _double)
        reg.register("double", "cpu", _double_alt, variant="alt")
        assert reg.select("double", "cpu", 8192).fn is _double
        table = table_cls()
        table.set_winner("double", "cpu", 8192, "alt", speedup=2.0,
                         median_s=1e-4)
        assert reg.select("double", "cpu", 8192,
                          table=table).fn is _double_alt
        # winner naming an unregistered variant falls back to the default
        table2 = table_cls()
        table2.set_winner("double", "cpu", 8192, "gone", speedup=2.0,
                          median_s=1e-4)
        assert reg.select("double", "cpu", 8192, table=table2).fn is _double


# ---------------------------------------------------------------------------
# session calibration lifecycle
# ---------------------------------------------------------------------------


def _flags(table):
    """'op/variant/kind/bucket' -> bit-identity flag and count."""
    return {k: (c.get("identical"), c["count"]) for k, c in table.cells()}


def test_session_calibrate_then_save_embeds_divergence(tmp_path):
    reg = OpRegistry()
    reg.register("double", "cpu", _double, calib=_make_f64)
    reg.register("double", "cpu", _double_alt, variant="alt")
    session = Session.emulated(n_cpu=1, accelerators=(), registry=reg,
                               device="cpu")
    try:
        table = session.calibrate(ops=["double"], nbytes=[8192], k=2,
                                  warmup=1)
        assert session.calibration is table
        assert session.runtime.calibration is table
        # both variants measured, non-default verified bit-identical
        assert table.cell("double", "cpu", 8192)["count"] == 1
        alt = table.cell("double", "cpu", 8192, variant="alt")
        assert alt["identical"] is True
        assert table.winner("double", "cpu", 8192)["speedup"] >= 1.0
        # run something so the divergence monitor has cells to embed
        session.submit("double", [np.arange(64, dtype=np.float64)]
                       ).result(timeout=60)
        session.barrier()
        path = tmp_path / "calib.json"
        session.save_calibration(str(path))
    finally:
        session.close()
    back = CalibrationTable.load(str(path))
    assert back.divergence is not None
    # a new session picks the snapshot up into its live monitor
    s2 = Session.emulated(n_cpu=1, accelerators=(), registry=reg,
                          calibration=str(path), device="cpu")
    try:
        assert s2.runtime.divergence.table() != {}
    finally:
        s2.close()
    # the JAX package's session writes the same cells and winners' keys
    jreg = japi.OpRegistry()
    jreg.register("double", "cpu", _double, calib=_make_f64)
    jreg.register("double", "cpu", _double_alt, variant="alt")
    js = japi.Session.emulated(n_cpu=1, accelerators=(), registry=jreg)
    try:
        jtable = js.calibrate(ops=["double"], nbytes=[8192], k=2, warmup=1)
    finally:
        js.close()
    assert _flags(table) == _flags(jtable)
    assert dict(table.winners()).keys() == dict(jtable.winners()).keys()


def test_calibrate_skips_ops_without_input_factory():
    tables = []
    for reg_cls, session_cls, cal, kw in (
            (OpRegistry, Session, calibrate, {"device": "cpu"}),
            (japi.OpRegistry, japi.Session, jcal.calibrate, {})):
        reg = reg_cls()
        reg.register("double", "cpu", _double)  # no calib= factory
        session = session_cls.emulated(n_cpu=1, accelerators=(),
                                       registry=reg, **kw)
        try:
            tables.append(cal(session, nbytes=[4096], k=1, warmup=1))
        finally:
            session.close()
    table, jtable = tables
    assert len(table) == 0 == len(jtable)
    assert "double" in table.meta["skipped_ops"]
    assert table.meta["skipped_ops"] == jtable.meta["skipped_ops"]


# ---------------------------------------------------------------------------
# tuned variants: bit-identity of every candidate vs the default
# ---------------------------------------------------------------------------


def test_tuned_variant_candidates_bit_identical_to_default():
    from repro.core.autotune import tunables as jtunables
    from repro_torch.core.autotune import tunables

    # the same search space as the JAX package's
    assert ([(t.op, t.param, t.default, tuple(t.candidates), t.bit_identical)
             for t in tunables()]
            == [(t.op, t.param, t.default, tuple(t.candidates),
                 t.bit_identical) for t in jtunables()])
    rng = np.random.default_rng(7)
    nb = 32 << 10
    for tun in tunables():
        if not tun.bit_identical:
            continue
        ins = [np.asarray(a) for a in tun.make_inputs(rng, nb)]
        ref = tun.fn(ins, **{tun.param: tun.default})
        for value in tun.candidates:
            outs = tun.fn(ins, **{tun.param: value})
            assert len(outs) == len(ref), tun.op
            for a, b in zip(outs, ref):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (
                    f"{tun.op}: {tun.param}={value} is not bit-identical "
                    f"to the default {tun.default}"
                )


def test_autotune_registers_variants_and_attaches_table():
    from repro.core.autotune import autotune as jautotune
    from repro.core.autotune import register_tunables as jregister
    from repro_torch.core.autotune import autotune, register_tunables

    reg = OpRegistry()
    ops = register_tunables(reg)
    assert set(ops) == {"fft_pallas", "zip_pallas", "flash_attention",
                        "mlstm", "rg_lru"}
    assert len(reg.variants("fft_pallas", "cpu")) == 3
    assert reg.variants("fft_pallas", "cpu")[0] == DEFAULT_VARIANT
    # double registration is idempotent only with replace
    with pytest.raises(ValueError, match="already registered"):
        reg.register("fft_pallas", "cpu", _double)
    register_tunables(reg)  # same fns → no-op, no raise
    jreg = japi.OpRegistry()
    assert jregister(jreg) == ops
    for op in ops:
        assert reg.variants(op, "cpu") == jreg.variants(op, "cpu")

    session = Session.emulated(n_cpu=1, accelerators=(), registry=reg,
                               device="cpu")
    try:
        table = autotune(session, nbytes=[16 << 10], k=1, warmup=1)
        assert session.runtime.calibration is table
        # every tuned op measured on the cpu kind
        measured = {key.split("/")[0] for key, _ in table.cells()}
        assert set(ops) <= measured
        # mlstm's chunk candidates change accumulation order: they must
        # be recorded as NOT identical, so the default always wins
        alts = [c for key, c in table.cells()
                if key.startswith("mlstm/chunk32/cpu/")]
        assert alts and all(c["identical"] is False for c in alts)
        win = [w for key, w in table.winners()
               if key.startswith("mlstm/cpu/")]
        assert win and all(w["variant"] == DEFAULT_VARIANT for w in win)
    finally:
        session.close()
    js = japi.Session.emulated(n_cpu=1, accelerators=(), registry=jreg)
    try:
        jtable = jautotune(js, nbytes=[16 << 10], k=1, warmup=1)
    finally:
        js.close()
    # the same cells with the same bit-identity flags, the same winners'
    # keys, and the default winning mlstm in both
    assert _flags(table) == _flags(jtable)
    assert dict(table.winners()).keys() == dict(jtable.winners()).keys()
    assert ([w["variant"] for k, w in table.winners()
             if k.startswith("mlstm/")]
            == [w["variant"] for k, w in jtable.winners()
                if k.startswith("mlstm/")])


# ---------------------------------------------------------------------------
# process backend: worker-side measurement + cross-process metric drain
# ---------------------------------------------------------------------------


def test_calibrate_process_backend_roundtrip_and_metric_drain(tmp_path):
    reg = OpRegistry()
    reg.register("scale", "gpu", elemwise.scale, calib=_make_f64)
    # same module-level fn, same params → bit-identical by construction
    reg.register("scale", "gpu", elemwise.scale, variant="alt",
                 params={"factor": 2.0})
    session = Session.emulated(n_cpu=0, accelerators=("gpu0",),
                               registry=reg, backend="process",
                               device="cpu")
    try:
        table = session.calibrate(ops=["scale"], nbytes=[8192], k=2,
                                  warmup=1)
        assert table.meta["backend"] == "process"
        cell = table.cell("scale", "gpu", 8192)
        assert cell is not None and cell["median_s"] > 0
        alt = table.cell("scale", "gpu", 8192, variant="alt")
        assert alt["identical"] is True
        assert table.winner("scale", "gpu", 8192)["speedup"] >= 1.0
        path = tmp_path / "proc.json"
        session.save_calibration(str(path))
    finally:
        session.close()
        session.runtime.close()
    # the calibration runs executed in the PE's subprocess worker; its
    # locally accumulated metrics must drain into the session registry
    tasks = session.metrics.counter("worker/gpu0/tasks").value
    assert tasks > 0
    back = CalibrationTable.load(str(path))
    assert back.state()["cells"] == table.state()["cells"]
    # the JAX package's process run writes the same cells and flags
    jreg = japi.OpRegistry()
    jreg.register("scale", "gpu", jelemwise.scale, calib=_make_f64)
    jreg.register("scale", "gpu", jelemwise.scale, variant="alt",
                  params={"factor": 2.0})
    js = japi.Session.emulated(n_cpu=0, accelerators=("gpu0",),
                               registry=jreg, backend="process")
    try:
        jtable = js.calibrate(ops=["scale"], nbytes=[8192], k=2, warmup=1)
    finally:
        js.close()
        js.runtime.close()
    assert _flags(table) == _flags(jtable)
    assert jtable.meta["backend"] == table.meta["backend"]
