"""The port's benchmarks (``benchmarks_torch/``) and examples
(``examples_torch/``) on the CPU, at the benches' smoke sizes.

The gated benches' ``gate`` dicts are modeled metrics (deterministic
priors, static placement, the executor's replay), so they must equal the
reference's committed baselines in ``benchmarks/baselines/`` (read in
place).  One gate is held to the JAX package's own value instead:
topology's ``spill_makespan_model`` at the smoke size, which the JAX
package today computes one ulp above its committed baseline (the port
gives the JAX package's bits).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks_torch import (bench_2fft, bench_2fzf, bench_3zip,
                              bench_alloc, bench_apps, bench_calibrate,
                              bench_graph, bench_marking, bench_pressure,
                              bench_serve, bench_stream, bench_topology,
                              check_regression, common, run)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"

SMOKES = {
    "graph": lambda jp: bench_graph.smoke(jp, backend="auto", device="cpu"),
    "pressure": lambda jp: bench_pressure.run_pressure(
        ways=4, n=1 << 12, json_path=jp, smoke=True, device="cpu"),
    "stream": lambda jp: bench_stream.run_stream(
        clients=4, chains=6, n=1 << 13, json_path=jp, smoke=True,
        device="cpu"),
    "topology": lambda jp: bench_topology.run_topology(
        ways=4, n=1 << 13, depth=2, json_path=jp, smoke=True, device="cpu"),
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Each gated bench's smoke record, written as the CLI writes it."""
    out = tmp_path_factory.mktemp("records")
    for name, smoke in SMOKES.items():
        smoke(str(out / f"BENCH_{name}.json"))
    return out


def _jax_topology_gate():
    from benchmarks import bench_topology as jtopo

    return jtopo.run_topology(ways=4, n=1 << 13, depth=2, json_path=None,
                              smoke=True)["gate"]


@pytest.mark.parametrize("name", list(SMOKES))
def test_smoke_gate_equals_baseline(records, name):
    rec = json.loads((records / f"BENCH_{name}.json").read_text())
    base = json.loads((BASELINES / f"BENCH_{name}.json").read_text())
    assert rec["bench"] == name and rec["params"] == base["params"]
    assert set(rec["gate"]) == set(base["gate"])
    off = {k for k in base["gate"] if rec["gate"][k] != base["gate"][k]}
    if name == "topology":
        assert off <= {"spill_makespan_model"}
        jgate = _jax_topology_gate()
        assert rec["gate"] == jgate  # the JAX package's bits, every key
        for k in off:
            assert abs(rec["gate"][k] - base["gate"][k]) <= math.ulp(
                base["gate"][k])
    else:
        assert not off, {k: (rec["gate"][k], base["gate"][k]) for k in off}
    if name == "graph":
        assert rec["backend"] == "thread"  # "auto" resolves to thread


def test_check_regression_passes_and_flags_a_doctored_record(
        records, tmp_path, capsys):
    paths = [str(records / f"BENCH_{n}.json") for n in SMOKES]
    assert check_regression.main(paths) == 0
    assert "perf-regression gate: OK" in capsys.readouterr().out
    rec = json.loads((records / "BENCH_graph.json").read_text())
    rec["gate"]["copies"] += 3  # 18 -> 21: over the 10 % tolerance
    bad = tmp_path / "BENCH_graph.json"
    bad.write_text(json.dumps(rec))
    report = tmp_path / "report.md"
    assert check_regression.main([str(bad), "--report", str(report)]) == 1
    assert "copies regressed" in capsys.readouterr().err
    assert "❌" in report.read_text()
    del rec["gate"]["makespan_model"]
    bad.write_text(json.dumps(rec))
    assert check_regression.main([str(bad)]) == 1
    assert "vanished" in capsys.readouterr().err


def test_check_regression_reads_the_reference_baselines_in_place():
    assert check_regression.DEFAULT_BASELINES == BASELINES


@pytest.mark.parametrize("bench", [bench_graph, bench_stream],
                         ids=["graph", "stream"])
def test_backend_process_raises(bench, monkeypatch):
    """Only the thread backend is ported (ROADMAP C.1): ``--backend
    process`` raises the port's resolve_backend error."""
    monkeypatch.setattr(sys, "argv", ["bench", "--smoke", "--backend",
                                      "process", "--device", "cpu",
                                      "--json", ""])
    with pytest.raises(NotImplementedError, match="process"):
        bench.main()


def test_run_dispatches_the_ported_benches(monkeypatch, tmp_path, capsys):
    calls = []

    def rec(name):
        return lambda *a, **kw: calls.append((name, a, kw))

    for mod, fn in ((bench_graph, "run"), (bench_graph, "smoke"),
                    (bench_pressure, "run_pressure"),
                    (bench_stream, "run_stream"),
                    (bench_topology, "run_topology"),
                    (bench_2fft, "run"), (bench_2fzf, "run"),
                    (bench_3zip, "run"), (bench_alloc, "run"),
                    (bench_apps, "run"), (bench_marking, "run"),
                    (bench_serve, "run_serve"),
                    (bench_calibrate, "run_calibrate")):
        monkeypatch.setattr(mod, fn, rec(f"{mod.__name__}.{fn}"))
    run.main(["--only", "graph,pressure,stream,topology,2fft",
              "--json-dir", str(tmp_path), "--device", "cpu"])
    by = {c[0].split(".", 1)[1]: c for c in calls}
    assert by["bench_graph.run"][2] == {"device": "cpu"}
    assert by["bench_graph.smoke"][2] == {
        "json_path": str(tmp_path / "BENCH_graph.json"), "device": "cpu"}
    assert by["bench_pressure.run_pressure"][2] == {
        "ways": 8, "n": 1 << 14, "smoke": False, "device": "cpu",
        "json_path": str(tmp_path / "BENCH_pressure.json")}
    assert by["bench_topology.run_topology"][2]["n"] == 1 << 14
    assert by["bench_stream.run_stream"][2]["n"] == 1 << 14
    assert by["bench_2fft.run"][2] == {"device": "cpu"}
    assert len(calls) == 6
    calls.clear()
    run.main(["--device", "cpu"])  # everything ported, the rest skipped
    assert sorted(c[0].split(".", 1)[1] for c in calls) == sorted([
        "bench_alloc.run", "bench_2fft.run", "bench_2fzf.run",
        "bench_3zip.run", "bench_apps.run", "bench_marking.run",
        "bench_graph.run", "bench_pressure.run_pressure",
        "bench_topology.run_topology", "bench_stream.run_stream",
        "bench_serve.run_serve", "bench_calibrate.run_calibrate"])
    out = capsys.readouterr().out
    for name in ("overhead", "roofline", "multitenant"):
        assert f"# --- {name}: not ported" in out


@pytest.mark.parametrize("name", sorted(run.NOT_PORTED))
def test_run_raises_for_a_bench_not_ported(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        run.main(["--only", name, "--device", "cpu"])


def test_run_traces_and_lints(tmp_path, monkeypatch):
    """``run.py`` with ``--trace-dir`` and ``--metrics-dir`` over a real
    bench: the port's trace exports and passes ``trace_lint``."""
    monkeypatch.setattr(bench_2fft, "SIZES", (64,))
    run.main(["--only", "2fft", "--device", "cpu", "--trace-dir",
              str(tmp_path / "t"), "--metrics-dir", str(tmp_path / "m")])
    doc = json.loads((tmp_path / "t" / "TRACE_2fft.json").read_text())
    assert doc["rimms"]["n_wall_events"] > 0
    assert json.loads((tmp_path / "m" / "METRICS_2fft.json").read_text())[
        "divergence"]


def test_paper_figure_benches_run_with_the_paper_counts():
    """Every paper-figure bench at its default sizes (one repeat): each
    emits its rows, and no copy-elimination check reads MISMATCH."""
    start = len(common.ROWS)
    bench_2fft.run(repeats=1, device="cpu")
    bench_2fzf.run(repeats=1, device="cpu")
    bench_3zip.run(repeats=1, device="cpu")
    bench_alloc.run(iters=5)
    bench_apps.run(repeats=1, device="cpu")
    bench_marking.run(repeat_counts=(1,), device="cpu")
    rows = common.ROWS[start:]
    names = [r.split(",", 1)[0] for r in rows]
    assert sum(n.startswith("fig5_2fft_") for n in names) == 12
    assert sum("OK" in r for r in rows if r.startswith("fig5_")) == 12
    assert not any("MISMATCH" in r for r in rows)
    assert sum(n.startswith("table1_2fzf_") for n in names) == 14
    assert sum(n.startswith("fig8_3zip_") for n in names) == 6
    assert sum(n.startswith("table2_") for n in names) == 6
    assert sum(n.startswith(("fig10_", "table3_")) for n in names) == 7
    assert "table1_2fzf_acc_only_n2048" in names
    for r in rows:
        if r.startswith(("table1_2fzf_acc_only", "fig8_3zip")):
            assert "copies 9->" in r  # the reference policy's nine


@pytest.mark.parametrize("example", ["quickstart.py", "radar_pipeline.py"])
def test_example_runs_on_the_cpu(example):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / example), "--device",
         "cpu"], capture_output=True, text=True, timeout=300, env=env,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    if example == "quickstart.py":
        assert "reference == rimms output" in proc.stdout
