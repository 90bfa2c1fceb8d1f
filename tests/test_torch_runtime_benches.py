"""The runtime's observability and QoS surface in the port, on the CPU:
the profile CLI (``repro_torch.profile``), ``bench_multitenant`` and
``bench_overhead`` (``benchmarks_torch/``) against the JAX package's
``repro.profile`` and ``benchmarks/bench_{multitenant,overhead}.py``.

The multitenant gate is modeled (the deterministic QoS replay), so the
port's smoke record must equal the committed
``benchmarks/baselines/BENCH_multitenant.json`` and the JAX package's own
run.  The overhead bench's ratios are host timings and are not asserted
here (the tests run beside other workers); its smoke gates run on the
card's machine (``chip_smoke.py`` phase 11).
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import bench_multitenant as jmt
from benchmarks_torch import (bench_multitenant, bench_overhead,
                              check_regression, common, run)
from repro import profile as jprofile
from repro_torch import profile
from repro_torch.apps.radar import make_session, submit_2fzf

# the module (``repro.core`` re-exports its ``trace`` function by that name)
jtrace_mod = importlib.import_module("repro.core.trace")

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"
SMOKE = dict(n=1 << 12, light_chains=4, heavy_chains=24)


def _structure(obj):
    """The nested key structure of a record (leaves left out)."""
    if isinstance(obj, dict):
        return {k: _structure(v) for k, v in obj.items()}
    return None


# ---------------------------------------------------------------------------
# profile CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """A session trace of two tenants' pinned 2FZF chains from each
    package, with its divergence table embedded, written as JSON."""
    out = tmp_path_factory.mktemp("traces")
    from repro.apps import radar as jradar

    paths = {}
    for name, make in (("port", lambda **kw: make_session(device="cpu",
                                                          **kw)),
                       ("jax", jradar.make_session)):
        submit = submit_2fzf if name == "port" else jradar.submit_2fzf
        s = make(n_cpu=1, accelerators=("gpu0",), scheduler="round_robin",
                 trace=True)
        try:
            for k in range(3):
                submit(s, 256, pins=("gpu0",) * 4, seed=9 + k,
                       tag=f"_{k}")["out"].result(timeout=120)
            s.barrier()
            s.close()
            s.context.tracer.set_divergence(s.runtime.divergence.table())
            paths[name] = out / f"TRACE_{name}.json"
            s.export_trace(str(paths[name]))
        finally:
            s.close()
            s.runtime.close()
    return paths


@pytest.mark.parametrize("source", ["port", "jax"])
def test_profile_report_equals_reference(traces, source):
    """Both packages' ``profile_report`` give the same text for one trace
    document, whichever package wrote it; every section is there."""
    doc = json.loads(traces[source].read_text())
    for top in (3, 10):
        text = profile.profile_report(doc, top=top, title=source)
        assert text == jprofile.profile_report(doc, top=top, title=source)
    for heading in ("### Top ops by wall time", "### Top ops by modeled time",
                    "### Critical path", "### Wall/modeled divergence"):
        assert heading in text
    assert "| fft |" in text and " tasks, " in text
    assert "| compute | " in text


def test_profile_cli_prints_the_reference_text(traces):
    """``python -m repro_torch.profile`` and ``python -m repro.profile``
    print the same text for the same traces and both exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = []
    for module in ("repro_torch.profile", "repro.profile"):
        proc = subprocess.run(
            [sys.executable, "-m", module, str(traces["port"]),
             str(traces["jax"]), "--top", "5"],
            capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[0] == outs[1] and outs[0].count("## Profile: ") == 2


def test_profile_main_exit_codes(traces, tmp_path, capsys):
    assert profile.main([str(traces["port"])]) == 0
    assert "Critical path" in capsys.readouterr().out
    truncated = tmp_path / "truncated.json"
    truncated.write_text('{"traceEvents": [')
    no_events = tmp_path / "no_events.json"
    no_events.write_text("{}")
    missing = tmp_path / "missing.json"
    for path in (truncated, no_events, missing):
        assert profile.main([str(path)]) == 1
    # one bad trace among good ones still fails the run
    assert profile.main([str(traces["port"]), str(missing)]) == 1
    err = capsys.readouterr().err
    assert "traceEvents" in err and "missing.json" in err


# ---------------------------------------------------------------------------
# bench_multitenant
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def multitenant(tmp_path_factory):
    """The port's multitenant smoke, written as the CLI writes it, with
    the bench's own smoke asserts (SLOs, percentiles, bit identity,
    completion, interference bound, fairness) on."""
    out = tmp_path_factory.mktemp("multitenant")
    path = out / "BENCH_multitenant.json"
    bench_multitenant.run_multitenant(json_path=str(path), smoke=True,
                                      device="cpu", **SMOKE)
    return json.loads(path.read_text()), path


def test_multitenant_smoke_gate_equals_baseline_and_reference(multitenant):
    rec, path = multitenant
    base = json.loads((BASELINES / "BENCH_multitenant.json").read_text())
    assert rec["params"] == base["params"]
    assert rec["gate"] == base["gate"]
    assert rec["gate"] == {
        "light_p95_model_s": 0.0005031119999999998,
        "light_p95_over_solo": 1.2181699847750538,
        "mix_makespan_model": 0.002169950399999997, "copies": 84}
    assert rec["gate_tolerances"] == base["gate_tolerances"]
    jrec = jmt.run_multitenant(json_path=None, smoke=True, **SMOKE)
    assert rec["gate"] == jrec["gate"]
    for key in ("light_p95_model_s", "light_p95_over_solo",
                "light_p95_over_solo_unbounded", "slo"):
        assert rec[key] == jrec[key], key
    for case in ("solo", "mix", "unbounded"):
        for key in ("makespan_model", "n_tasks", "n_completed", "copies",
                    "jain_lights", "latency_percentiles"):
            assert rec[case][key] == jrec[case][key], (case, key)
    # the record's keys are the reference's, down to every nested dict
    assert _structure(rec) == _structure(json.loads(json.dumps(jrec)))
    assert check_regression.main([str(path)]) == 0


def test_multitenant_record_holds_the_smoke_claims(multitenant):
    rec, _ = multitenant
    assert rec["bit_identical"] is True
    slo = rec["slo"]
    for c in range(bench_multitenant.N_LIGHTS):
        assert slo[f"light{c}"]["violations"] == 0
        assert not slo[f"light{c}"]["breached"]
    assert slo["heavy"]["violations"] == slo["heavy"]["tasks"] > 0
    assert slo["heavy"]["burn_rate"] > 1.0
    for case, chains in (("solo", 12), ("mix", 36), ("unbounded", 36)):
        assert rec[case]["n_completed"] == rec[case]["n_tasks"] == 4 * chains
    pct = rec["mix"]["latency_percentiles"]
    for name in ("light0", "light1", "light2", "heavy"):
        assert 0.0 < pct[name]["p50"] <= pct[name]["p95"] <= pct[name]["p99"]
    assert rec["light_p95_over_solo"] <= 2.0 < rec[
        "light_p95_over_solo_unbounded"]


def test_multitenant_gate_regression_is_flagged(multitenant, tmp_path):
    """``check_regression`` gates the record with the baseline's own
    tolerances: the ratio's 25 % passes at +20 % and fails at +30 %."""
    rec, _ = multitenant
    path = tmp_path / "BENCH_multitenant.json"
    base = rec["gate"]["light_p95_over_solo"]
    for factor, rc in ((1.20, 0), (1.30, 1)):
        doctored = json.loads(json.dumps(rec))
        doctored["gate"]["light_p95_over_solo"] = base * factor
        path.write_text(json.dumps(doctored))
        assert check_regression.main([str(path)]) == rc


def test_multitenant_cli_traces_and_lints(tmp_path, monkeypatch):
    """The CLI at a reduced depth on the CPU with ``--trace-dir`` and
    ``--metrics-dir``: the trace lints, the profile CLI reads it, and
    without ``--device`` the bench demands CUDA."""
    monkeypatch.chdir(tmp_path)
    bench_multitenant.main(["--smoke", "--device", "cpu", "--n", "256",
                            "--light-chains", "2", "--heavy-chains", "4",
                            "--trace-dir", "t", "--metrics-dir", "m",
                            "--json", "rec.json"])
    doc = json.loads((tmp_path / "t" / "TRACE_multitenant.json").read_text())
    assert jtrace_mod.trace_lint(doc) == []
    assert json.loads((tmp_path / "m" / "METRICS_multitenant.json")
                      .read_text())["divergence"]
    assert profile.main([str(tmp_path / "t" / "TRACE_multitenant.json")]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_multitenant.main(["--smoke", "--json", ""])


# ---------------------------------------------------------------------------
# bench_overhead
# ---------------------------------------------------------------------------


def test_overhead_record_and_rows():
    """The port's overhead bench at 2000 calls: the reference's record
    keys and its six rows, each with its derived fields (ratios are host
    timings and are not asserted here)."""
    start = len(common.ROWS)
    rec = bench_overhead.run(n_calls=2000, device="cpu")
    rows = common.ROWS[start:]
    assert [r.split(",", 1)[0] for r in rows] == [
        "sec522_flag_check", "trace_flag_check_traced",
        "trace_flag_check_paused", "trace_instant_enabled",
        "trace_instant_paused", "sampler_flag_check"]
    assert "cycles@1.2GHz=" in rows[0] and "checks=" in rows[0]
    assert "x_baseline=" in rows[1] and "x_baseline=" in rows[2]
    assert "ns_per_event=" in rows[3] and "ns_per_event=" in rows[4]
    assert "x_off=" in rows[5] and "samples=" in rows[5]
    assert set(rec) == {"flag", "instant", "sampled", "ratio_traced",
                        "ratio_paused", "ratio_sampled"}
    assert set(rec["flag"]) == {"baseline", "traced", "paused",
                                "flag_checks"}
    assert set(rec["instant"]) == {"enabled", "paused"}
    assert set(rec["sampled"]) == {"off", "on", "last_run_samples"}
    # warm-up and 5 repeats of three configurations, one check a call
    assert rec["flag"]["flag_checks"] == 16 * 2000
    assert all(v > 0 for v in (rec["ratio_traced"], rec["ratio_paused"],
                               rec["ratio_sampled"]))
    assert bench_overhead.REPEATS == 5 and bench_overhead.SMOKE_RATIO == 1.30


def test_overhead_cli_names_the_host_cpu(capsys):
    bench_overhead.main(["--n-calls", "500", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"# host cpu: {common.host_cpu()}"
    assert out[1] == "name,us_per_call,derived"


def test_overhead_gate_failure_shows_the_repeats(monkeypatch):
    """A crossing of the smoke gate names the per-repeat ns/call of every
    configuration, so noise in some repeats can be told from a hot-path
    regression that moves them all."""
    monkeypatch.setattr(bench_overhead, "SMOKE_RATIO", 0.0)
    with pytest.raises(AssertionError) as err:
        bench_overhead.run(n_calls=300, smoke=True, device="cpu")
    msg = str(err.value)
    assert "gate: <=0.0x" in msg and "per-repeat ns/call" in msg
    for k in ("baseline", "traced", "paused"):
        series = msg.split(f"{k} [", 1)[1].split("]", 1)[0].split()
        assert len(series) == bench_overhead.REPEATS
        assert all(float(x) > 0 for x in series)


@pytest.mark.parametrize("repeats", [3, 7])
def test_overhead_repeats_set_every_median(monkeypatch, repeats):
    """``repeats`` (``--repeats`` on the CLI) sets how many interleaved
    repeats each configuration's median is taken over; the gate stays
    1.30."""
    start = len(common.ROWS)
    bench_overhead.main(["--n-calls", "300", "--device", "cpu",
                         "--repeats", str(repeats)])
    # warm-up and `repeats` repeats of three configurations
    assert f"checks={(1 + 3 * repeats) * 300}" in common.ROWS[start]
    monkeypatch.setattr(bench_overhead, "SMOKE_RATIO", 0.0)
    with pytest.raises(AssertionError) as err:
        bench_overhead.run(n_calls=300, smoke=True, device="cpu",
                           repeats=repeats)
    msg = str(err.value)
    for k in ("baseline", "traced", "paused"):
        series = msg.split(f"{k} [", 1)[1].split("]", 1)[0].split()
        assert len(series) == repeats


# ---------------------------------------------------------------------------
# run.py
# ---------------------------------------------------------------------------


def test_run_dispatches_overhead_and_multitenant(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(bench_overhead, "run",
                        lambda *a, **kw: calls.append(("overhead", a, kw)))
    monkeypatch.setattr(
        bench_multitenant, "run_multitenant",
        lambda *a, **kw: calls.append(("multitenant", a, kw)))
    run.main(["--only", "overhead,multitenant", "--json-dir", str(tmp_path),
              "--device", "cpu"])
    assert calls == [
        ("overhead", (), {"n_calls": 200_000, "device": "cpu"}),
        ("multitenant", (), {
            "n": 1 << 13, "light_chains": 8, "heavy_chains": 64,
            "json_path": str(tmp_path / "BENCH_multitenant.json"),
            "smoke": False, "device": "cpu"}),
    ]
    assert run.NOT_PORTED == {}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_multitenant_smoke_on_the_card(tmp_path):
    """The multitenant smoke with accelerator spaces on ``cuda:0``: the
    gate equals the baseline and every device task launched its kernel
    (three FFT launches and one ZIP launch a chain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels.fft import fft as F
    from repro_torch.kernels.zip import zip as Z

    F.launches = Z.launches = 0
    rec = bench_multitenant.run_multitenant(json_path=None, smoke=True,
                                            **SMOKE)
    base = json.loads((BASELINES / "BENCH_multitenant.json").read_text())
    assert rec["gate"] == base["gate"] and rec["bit_identical"] is True
    assert (F.launches, Z.launches) == (3 * 84, 84)
    assert np.isfinite(rec["light_p95_model_s"]["mix"])
