"""The port's radar main path against the JAX package's, chain by chain.

Both packages build the same chains from the same seed (``_fill`` is
the same numpy code in both) and run them under both memory policies
with ``scheduler="round_robin"``, whose placements rest on deterministic
priors only.  Ledger copy counts, bytes per (src, dst) pair, placements
and the modeled makespan must be exactly equal; outputs must agree
within a tolerance (see ``OUT_RTOL``).
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.apps.radar as jradar
import repro_torch.apps.radar as tradar
from repro.core.api import Session as JSession
from repro.core.calibrate import CalibrationTable as JTable
from repro_torch.core.api import Session as TSession
from repro_torch.core.calibrate import CalibrationTable as TTable

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The JAX side runs XLA's jnp.fft on its device PEs; the port's CPU side
# runs the plain Stockham loop.  The two transforms round differently,
# and a chain compounds up to three transforms: rtol 1e-3, atol 1e-3*sqrt(n).
OUT_RTOL = 1e-3


def _out_atol(n):
    return 1e-3 * n ** 0.5


CHAINS = {
    "2fft-64": (lambda m, c: m.build_2fft(c, 64, seed=1), {}, 64),
    "2fft-256": (lambda m, c: m.build_2fft(c, 256, seed=2), {}, 256),
    "2fzf-64": (lambda m, c: m.build_2fzf(c, 64, seed=3), {}, 64),
    "2fzf-256": (lambda m, c: m.build_2fzf(c, 256, seed=4), {}, 256),
    # a range length that is not a power of two: Bluestein's algorithm in
    # the port's FFT, XLA's FFT at any length on the JAX side
    "2fft-1000": (lambda m, c: m.build_2fft(c, 1000, seed=9), {}, 1000),
    "2fzf-1000": (lambda m, c: m.build_2fzf(c, 1000, seed=10), {}, 1000),
    "3zip-128": (lambda m, c: m.build_3zip(c, 128, seed=5), {}, 128),
    "rc": (lambda m, c: m.build_rc(c, seed=6), {}, 256),
    "pd-8x128": (lambda m, c: m.build_pd(c, ways=8, n=128, seed=7), {}, 128),
    "sar-64": (lambda m, c: m.build_sar(c, scale=64, seed=8),
               {"accelerators": ("fft_acc0", "zip_acc0")}, 512),
}


def _outputs(bufs):
    """Every HeteData output of a built chain, in a fixed order."""
    if "phase1" in bufs:  # SAR: two fragmented phases
        points = [bufs["phase1"], bufs["phase2"]]
    elif isinstance(bufs["out"], tuple):  # PD: (parent, fragments)
        points = [bufs]
    else:
        return [bufs["out"]]
    return [frag for p in points for frag in p["out"][1]]


def _run(mod, chain, policy, device_kw):
    build, soc_kw, _ = CHAINS[chain]
    rt, ctx = mod.make_runtime(policy=policy, scheduler="round_robin",
                               **soc_kw, **device_kw)
    bufs, tasks = build(mod, ctx)
    rt._run_impl(tasks)
    outs = [ctx.sync(hd).copy() for hd in _outputs(bufs)]
    return rt, ctx, outs


@pytest.mark.parametrize("policy", ["reference", "rimms"])
@pytest.mark.parametrize("chain", list(CHAINS))
def test_chain_matches_jax(chain, policy):
    jrt, jctx, jouts = _run(jradar, chain, policy, {})
    trt, tctx, touts = _run(tradar, chain, policy, {"device": "cpu"})
    assert tctx.ledger.total_copies == jctx.ledger.total_copies
    assert dict(tctx.ledger.copies) == dict(jctx.ledger.copies)
    assert dict(tctx.ledger.bytes_moved) == dict(jctx.ledger.bytes_moved)
    assert trt.task_log == jrt.task_log
    assert trt.last_makespan_model == jrt.last_makespan_model
    n = CHAINS[chain][2]
    for t, j in zip(touts, jouts, strict=True):
        np.testing.assert_allclose(t, j, rtol=OUT_RTOL, atol=_out_atol(n))


def _copies(builder, pins, policy):
    rt, ctx = tradar.make_runtime(policy=policy, device="cpu")
    _, tasks = builder(ctx, pins)
    rt._run_impl(tasks)
    return ctx.ledger.total_copies


def test_paper_copy_counts():
    """Paper Figs 5 and 8 (the counts tests/test_runtime.py pins)."""
    fft2 = lambda c, p: tradar.build_2fft(c, 256, pins=p)  # noqa: E731
    zip3 = lambda c, p: tradar.build_3zip(c, 128, pins=p)  # noqa: E731
    acc = ("gpu0", "gpu0")
    assert _copies(fft2, acc, "reference") == 4
    assert _copies(fft2, acc, "rimms") == 1
    mixed = ("cpu0", "gpu0")
    assert (_copies(fft2, mixed, "reference")
            - _copies(fft2, mixed, "rimms")) == 1
    assert _copies(zip3, ("gpu0",) * 3, "reference") == 9
    assert _copies(zip3, ("gpu0",) * 3, "rimms") == 4


def test_session_2fzf_matches_jax():
    res = {}
    for name, cls, kw in (("jax", JSession, {}),
                          ("torch", TSession, {"device": "cpu"})):
        with cls.emulated(scheduler="round_robin", **kw) as s:
            chains = [jradar.submit_2fzf(s, 128, seed=i, tag=str(i))
                      if name == "jax" else
                      tradar.submit_2fzf(s, 128, seed=i, tag=str(i))
                      for i in range(3)]
            outs = [c["out"].result().copy() for c in chains]
            s.barrier()
            res[name] = (outs, dict(s.ledger.copies),
                         dict(s.ledger.bytes_moved),
                         s.report()["makespan_model"])
    (jo, jc, jb, jm), (to, tc, tb, tm) = res["jax"], res["torch"]
    assert (tc, tb, tm) == (jc, jb, jm)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t, j, rtol=OUT_RTOL, atol=_out_atol(128))


def test_calibration_table_from_jax_loads(tmp_path):
    with JSession.emulated(scheduler="round_robin") as s:
        table = s.calibrate(ops=("fft", "zip"), nbytes=(4096, 65536), k=1,
                            warmup=1)
    table.set_winner("fft", "gpu", 4096, "block32", speedup=1.5,
                     median_s=1e-5)
    path = tmp_path / "calib.json"
    table.save(path)
    loaded = TTable.load(path)
    assert loaded.state() == JTable.load(path).state()
    assert len(loaded) == len(table) > 0
    for key, cell in table.cells():
        op, _variant, kind, _bucket = key.split("/")
        nb = cell["nbytes"]
        assert loaded.best_variant(op, kind, nb) == table.best_variant(
            op, kind, nb)
        assert loaded.estimate_s(op, kind, nb) == table.estimate_s(
            op, kind, nb)
    assert loaded.best_variant("fft", "gpu", 4096) == "block32"


def test_port_calibrates_device_kinds():
    """The harness ingests inputs into the PE's space before timing, so
    the port's device op receives tensors, not numpy arrays."""
    with TSession.emulated(scheduler="round_robin", device="cpu") as s:
        table = s.calibrate(ops=("zip",), nbytes=(4096,), k=1, warmup=1)
    assert table.cell("zip", "gpu", 4096) is not None
    assert table.cell("zip", "cpu", 4096) is not None


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        import repro_torch.apps.radar as radar
        rt, ctx = radar.make_runtime(policy="rimms", device="cpu")
        bufs, tasks = radar.build_2fzf(ctx, 64, pins=("gpu0",) * 4)
        rt._run_impl(tasks)
        assert ctx.ledger.total_copies == 2  # the two inputs, once each
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
