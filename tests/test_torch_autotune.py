"""The port's autotuning path (``repro_torch.core.autotune``,
``repro_torch.rimms``, ``python -m repro_torch.calibrate``,
``benchmarks_torch/bench_calibrate.py``) against the JAX package.

Everything here runs on the CPU: the port's sessions are built with
``device="cpu"`` and its tuned ops run the kernels' plain versions on a
cpu PE, as the reference runs its Pallas kernels (in interpret mode) on
its cpu PEs.  The CUDA side of this path runs in ``chip_smoke.py``.
"""

import ast
import io
import json
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.rimms as jrimms
from repro.core.api import OpRegistry as JRegistry
from repro.core.api import Session as JSession
from repro.core.autotune import autotune as jautotune
from repro.core.autotune import tunables as jtunables
from repro_torch import rimms
from repro_torch.calibrate import main as cli
from repro_torch.core.api import OpRegistry, Session
from repro_torch.core.autotune import (TUNED_KINDS, autotune,
                                       register_tunables, tunables,
                                       tuned_summary)
from repro_torch.core.calibrate import DEFAULT_VARIANT, CalibrationTable

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)

#: the first rung of the reference's DEFAULT_LADDER
RUNG = 64 << 10
#: per-op tolerances of tests/test_kernels.py (fft at N = 1024: rtol
#: 5e-4, atol rtol * sqrt(N))
TOL = {"fft_pallas": (5e-4, 5e-4 * 32), "zip_pallas": (1e-5, 1e-5),
       "flash_attention": (2e-4, 2e-4), "mlstm": (2e-3, 2e-3),
       "rg_lru": (1e-4, 1e-4)}


def cpu_session(registry, **kw):
    return Session.emulated(n_cpu=1, accelerators=(), registry=registry,
                            device="cpu", **kw)


def make(tun, nbytes, seed=0):
    rng = np.random.default_rng([seed, int(nbytes)])
    return [np.asarray(a) for a in tun.make_inputs(rng, int(nbytes))]


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- tunables ----
def test_tunables_equal_the_reference_field_by_field():
    mine, ref = tunables(), jtunables()
    assert [t.op for t in mine] == [t.op for t in ref]
    for a, b in zip(mine, ref):
        assert (a.op, a.param, a.default, a.candidates, a.bit_identical) == (
            b.op, b.param, b.default, b.candidates, b.bit_identical)
    assert TUNED_KINDS == ("cpu", "gpu", "acc")


@pytest.mark.parametrize("nbytes", [16 << 10, 64 << 10, 1 << 20])
def test_input_factories_byte_identical(nbytes):
    for a, b in zip(tunables(), jtunables()):
        xs, ys = make(a, nbytes, seed=3), make(b, nbytes, seed=3)
        assert len(xs) == len(ys), a.op
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and x.shape == y.shape, a.op
            assert x.tobytes() == y.tobytes(), a.op


@pytest.mark.parametrize("op", [t.op for t in tunables()])
def test_tuned_op_matches_reference_at_first_rung(op):
    """The op registered by the port on the cpu kind, called as the
    runtime calls it, against the reference's op (its Pallas kernel in
    interpret mode) on the same inputs."""
    reg = OpRegistry()
    register_tunables(reg)
    var = reg.variant(op, "cpu", DEFAULT_VARIANT)
    tun = next(t for t in jtunables() if t.op == op)
    ins = make(tun, RUNG)
    got = var.fn([a.copy() for a in ins], **var.params)
    want = tun.fn(ins)
    assert len(got) == len(want)
    rtol, atol = TOL[op]
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)  # a cpu PE gets host arrays back
        assert g.shape == np.asarray(w).shape and g.dtype == np.asarray(w).dtype
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("op", [t.op for t in tunables()])
def test_tuned_op_takes_tensors_on_a_device_pe(op):
    """On a device PE the op receives tensors of the PE's space and
    returns tensors there (CPU tensors here; CUDA on the card)."""
    reg = OpRegistry()
    register_tunables(reg)
    tun = next(t for t in tunables() if t.op == op)
    ins = make(tun, 16 << 10)
    on_host = reg.variant(op, "cpu", DEFAULT_VARIANT).fn(ins)
    on_dev = reg.variant(op, "gpu", DEFAULT_VARIANT).fn(
        [torch.from_numpy(a.copy()) for a in ins])
    for h, d in zip(on_host, on_dev):
        assert isinstance(d, torch.Tensor)
        assert h.tobytes() == d.numpy().tobytes()


# -------------------------------- ports of tests/test_calibrate.py:258-308 ----
def test_tuned_variant_candidates_bit_identical_to_default():
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
                assert host(a).tobytes() == host(b).tobytes(), (
                    f"{tun.op}: {tun.param}={value} is not bit-identical "
                    f"to the default {tun.default}"
                )


def _double(ins):
    return np.asarray(ins[0]) * 2.0


def test_autotune_registers_variants_and_attaches_table():
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

    session = cpu_session(reg)
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
        # the bit-identical ops' candidates measured identical
        for key, c in table.cells():
            op, variant = key.split("/")[:2]
            if op != "mlstm" and variant != DEFAULT_VARIANT:
                assert c["identical"] is True, key
        assert set(tuned_summary(table)) == {
            key for key, _ in table.winners()}
    finally:
        session.close()


# ---------------------------------------------- tables across packages ----
def _submit(session, op, ins):
    if op == "rg_lru":
        outs = [session.malloc(ins[0].shape, np.float32),
                session.malloc(ins[2].shape, np.float32)]
        futs = session.submit(op, list(ins), out=outs)
        return [f.result() for f in futs]
    return [session.submit(op, list(ins)).result()]


def test_jax_autotune_table_dispatches_same_variants_in_port(tmp_path):
    nb = 16 << 10
    jsession = JSession.emulated(n_cpu=1, accelerators=(),
                                 registry=JRegistry())
    try:
        table = jautotune(jsession, nbytes=[nb], k=1, warmup=1)
        path = tmp_path / "jax_calib.json"
        jsession.save_calibration(path)
        reg = OpRegistry()
        register_tunables(reg)
        session = cpu_session(reg, calibration=str(path))
        try:
            assert session.runtime.calibration.state()["winners"] == \
                table.state()["winners"]
            jsession.runtime.reset_stats()
            session.runtime.reset_stats()
            for tun in tunables():
                ins = make(tun, nb)
                got = _submit(session, tun.op, ins)
                want = _submit(jsession, tun.op, ins)
                rtol, atol = TOL[tun.op]
                for g, w in zip(got, want):
                    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
            session.barrier()
            jsession.barrier()
            assert session.runtime.variant_log == jsession.runtime.variant_log
            want_log = [(op, kind, w["variant"]) for key, w in table.winners()
                        for op, kind, _b in [key.split("/")]
                        if w["variant"] != DEFAULT_VARIANT]
            assert sorted(session.runtime.variant_log) == sorted(want_log)
        finally:
            session.close()
    finally:
        jsession.close()


def test_port_table_has_reference_format(tmp_path):
    reg = OpRegistry()
    session = cpu_session(reg)
    try:
        autotune(session, nbytes=[16 << 10], k=1, warmup=1)
        path = tmp_path / "port_calib.json"
        session.save_calibration(path)
    finally:
        session.close()
    from repro.core.calibrate import CalibrationTable as JTable

    assert JTable.load(path).state() == CalibrationTable.load(path).state()


# ------------------------------------------------------------------ CLI ----
def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = cli(argv)
    return code, buf.getvalue()


@pytest.fixture(scope="module")
def port_table(tmp_path_factory):
    reg = OpRegistry()
    session = cpu_session(reg)
    try:
        table = autotune(session, nbytes=[16 << 10], k=1, warmup=1)
        path = tmp_path_factory.mktemp("calib") / "port.json"
        session.save_calibration(path)
    finally:
        session.close()
    return table, path


def test_cli_show_round_trips(port_table):
    table, path = port_table
    code, out = _cli(["show", str(path), "--json"])
    assert code == 0
    assert json.loads(out) == json.loads(json.dumps(
        CalibrationTable.load(path).state(), sort_keys=True))
    assert json.loads(out)["winners"] == table.state()["winners"]
    code, md = _cli(["show", str(path)])
    assert code == 0 and md.startswith("## Calibration table")
    for key, _ in table.winners():
        assert f"| {key.split('/')[0]} | cpu |" in md
    code, rep = _cli(["--report", str(path)])
    assert code == 0 and f"# Calibration report — {path}" in rep


def test_cli_diff_round_trips(port_table, tmp_path):
    table, path = port_table
    code, out = _cli(["diff", str(path), str(path), "--exit-code"])
    assert (code, json.loads(out)) == (0, {})
    other = CalibrationTable.load(path)
    key, win = other.winners()[0]
    op, kind, bucket = key.split("/")
    other.set_winner(op, kind, bucket, "other", speedup=2.0, median_s=0.0)
    moved = tmp_path / "moved.json"
    other.save(moved)
    code, out = _cli(["diff", str(path), str(moved), "--exit-code"])
    assert code == 1
    assert json.loads(out)[f"winner:{key}"] == {"a": win["variant"],
                                                "b": "other"}
    assert _cli(["diff", str(path), str(moved)])[0] == 0


def test_cli_run_needs_cuda(tmp_path):
    """``run`` builds its session on the CUDA device, as the reference's
    CLI builds its on the accelerator: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py drives run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["run", "--out", str(tmp_path / "x.json"), "--ladder", "64KiB"])


def _options(prog_main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit):
        prog_main(argv)
    text = buf.getvalue()
    return sorted({tok.rstrip(",") for tok in text.split()
                   if tok.startswith("-") and tok[1:2].isalpha() or
                   tok.startswith("--")})


@pytest.mark.parametrize("sub", ["run", "show", "diff"])
def test_cli_flags_equal_the_reference(sub):
    from repro.calibrate import main as jcli

    assert _options(cli, [sub, "--help"]) == _options(jcli, [sub, "--help"])


# ------------------------------------------------------------ namespace ----
def test_rimms_namespace_matches_reference():
    assert set(jrimms.__all__) - set(rimms.__all__) == {"WorkerDied"}
    assert set(rimms.__all__) <= set(jrimms.__all__)
    for name in rimms.__all__:
        assert getattr(rimms, name) is not None
    assert rimms.autotune is autotune


# ----------------------------------------------------- bench_calibrate ----
def test_bench_calibrate_part_a_equals_reference_baseline():
    from benchmarks_torch import bench_calibrate

    plan = bench_calibrate.run_plan_gate(device="cpu")
    base = json.loads((ROOT / "benchmarks" / "baselines"
                       / "BENCH_calibrate.json").read_text())["plan"]
    assert plan == base
    assert plan["calibrated_vs_prior_makespan"] == 0.17131960565638865


def test_bench_calibrate_smoke_on_cpu(tmp_path):
    from benchmarks_torch import bench_calibrate

    out = tmp_path / "BENCH_calibrate.json"
    rec = bench_calibrate.run_calibrate(json_path=str(out), smoke=False,
                                        device="cpu")
    assert rec["plan_equals_reference"] is True
    tune = rec["autotune"]
    assert tune["skipped_ops"] == []
    assert {k.split("/")[0] for k in tune["tuned_winners"]} == {
        t.op for t in tunables()}
    for kind, check in tune["dispatch"].items():
        assert kind == "cpu"
        assert check["selected_winner"] and check["bit_identical"], check
    assert json.loads(out.read_text())["plan"] == rec["plan"]


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_benchmarks_import_no_jax():
    files = sorted((ROOT / "benchmarks_torch").rglob("*.py"))
    files += sorted((ROOT / "examples_torch").rglob("*.py"))
    assert len(files) >= 4
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), (
                f"{path}: {name}")


def test_autotune_path_runs_with_jax_blocked(tmp_path):
    code = textwrap.dedent(f"""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import torch
        torch.set_num_threads(1)
        import repro_torch.rimms as rimms
        from repro_torch.calibrate import main
        s = rimms.Session.emulated(n_cpu=1, accelerators=(), device="cpu",
                                   registry=rimms.OpRegistry())
        t = rimms.autotune(s, nbytes=[16 << 10], k=1, warmup=1)
        s.save_calibration({str(tmp_path / 'c.json')!r})
        s.close()
        assert main(["show", {str(tmp_path / 'c.json')!r}]) == 0
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
        print("ok", len(t))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("ok ")
