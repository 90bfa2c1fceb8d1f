"""Measured calibration + launch-parameter autotuning bench of the port.

Two claims are checked, as ``benchmarks/bench_calibrate.py`` checks
them for the reference:

* **Calibrated placement** (part A, fully deterministic): on an
  emulated platform whose *measured* throughputs invert the
  ``CostModel`` priors (the priors claim the GPU is the fastest kind;
  the synthetic "truth" calibration says the GPU is slow and the
  fixed-function accelerators fast), a static HEFT plan built from the
  calibrated model must cost no more than the prior-built plan when
  both are priced under the truth model.  Nothing executes, so
  ``calibrated_vs_prior_makespan`` is exact and must equal the
  reference's committed baseline
  (``benchmarks/baselines/BENCH_calibrate.json``, read in place).

* **Autotuned variants** (part B, measured): a live
  :func:`repro_torch.core.autotune.autotune` pass over the kernels'
  launch parameters, on a CPU PE and — on the card — a ``gpu0`` PE.  It
  must find at least one non-default variant winning with a measured
  speedup ≥ 1.0, and dispatching each PE kind's best winning op through
  the calibrated session must (a) select the winner
  (``Runtime.variant_log``) and (b) produce output bit-identical to the
  default variant.

Emits ``BENCH_calibrate.json``.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_calibrate [--smoke] [--json PATH]
      (on the CUDA device; the functions take ``device="cpu"``, which the
      tests pass, to run on CPU tensors without a ``gpu0`` PE)
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .common import emit

#: the reference's committed record, compared with part A exactly
BASELINE = (Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"
            / "BENCH_calibrate.json")

#: part A workload: unpinned 2FZF chains at these sizes (complex64 n)
PLAN_SIZES = (1 << 12, 1 << 14, 1 << 16)
PLAN_CHAINS = 6
#: truth throughputs (bytes/s) for the synthetic calibration table —
#: deliberately inverting the CostModel priors (gpu 1.6e10 → slow,
#: acc 8e9 → fastest)
TRUE_THROUGHPUT = {"cpu": 1.0e9, "acc": 1.6e10, "gpu": 0.8e9}
#: buckets the truth table covers (must span every task's in_bytes)
TRUTH_LADDER = tuple(1 << p for p in range(12, 23))

AUTOTUNE_LADDER = (64 << 10, 1 << 20)
AUTOTUNE_LADDER_SMOKE = (64 << 10,)


def _truth_table():
    """Synthetic measured truth: linear-in-bytes timings from
    TRUE_THROUGHPUT, one cell per (op, kind, bucket)."""
    from repro_torch.core.calibrate import CalibrationTable
    from repro_torch.core.graph import CostModel

    table = CalibrationTable()
    table.meta["synthetic"] = "bench_calibrate part A truth model"
    for op in ("fft", "ifft", "zip"):
        w = CostModel.OP_WEIGHT.get(op, 2.0)
        for kind, thr in TRUE_THROUGHPUT.items():
            for nb in TRUTH_LADDER:
                s = CostModel.LAUNCH_LATENCY_S + nb * w / thr
                table.record(op, "default", kind, nb, s)
    return table


def run_plan_gate(device=None) -> dict:
    """Part A: prior-HEFT vs calibrated-HEFT, both priced under truth."""
    from repro_torch.apps.radar import build_2fzf, make_runtime
    from repro_torch.core.calibrate import heft_plan, simulate_plan
    from repro_torch.core.graph import CostModel

    rt, ctx = make_runtime(
        policy="rimms", scheduler="heft", n_cpu=1,
        accelerators=("gpu0", "fft_acc0", "zip_acc0"), device=device,
    )
    try:
        tasks = []
        for i in range(PLAN_CHAINS):
            n = PLAN_SIZES[i % len(PLAN_SIZES)]
            _, chain = build_2fzf(ctx, n, pins=(None,) * 4, seed=100 + i)
            tasks += chain

        truth = _truth_table()
        prior_cm = CostModel()                  # BASE_THROUGHPUT priors
        calib_cm = CostModel(calibration=truth)  # measured truth attached

        prior_plan = heft_plan(rt, tasks, cost_model=prior_cm)
        calib_plan = heft_plan(rt, tasks, cost_model=calib_cm)
        # price BOTH plans under the truth model — plan quality, not
        # model optimism, is what's compared
        prior_cost = simulate_plan(rt, tasks, prior_plan, cost_model=calib_cm)
        calib_cost = simulate_plan(rt, tasks, calib_plan, cost_model=calib_cm)
    finally:
        rt.close()
    ratio = calib_cost / max(prior_cost, 1e-12)

    def _spread(plan):
        names = sorted(set(plan))
        return {pe: plan.count(pe) for pe in names}

    emit(
        "calibrate_plan_gate", calib_cost * 1e6,
        f"prior_ms={prior_cost * 1e3:.3f};calib_ms={calib_cost * 1e3:.3f};"
        f"ratio={ratio:.3f};tasks={len(tasks)}",
    )
    return {
        "n_tasks": len(tasks),
        "prior_plan_makespan_s": prior_cost,
        "calibrated_plan_makespan_s": calib_cost,
        "calibrated_vs_prior_makespan": ratio,
        "prior_plan_spread": _spread(prior_plan),
        "calibrated_plan_spread": _spread(calib_plan),
    }


def baseline_plan() -> dict:
    """The reference's committed part-A record."""
    return json.loads(BASELINE.read_text())["plan"]


def _inputs_for_bucket(tun, ladder, bucket):
    """The calibration inputs of ``tun`` whose shape bucket is ``bucket``
    (regenerated from the seed the harness used)."""
    from repro_torch.core.telemetry import shape_bucket

    for n in ladder:
        rng = np.random.default_rng([0, int(n)])
        made = [np.asarray(a) for a in tun.make_inputs(rng, int(n))]
        if shape_bucket(sum(a.nbytes for a in made)) == bucket:
            return made
    raise AssertionError((tun.op, bucket, ladder))


def _dispatch_check(session, tun, win, kind, ins) -> dict:
    """Submit ``tun.op`` pinned to a PE of ``kind``; the runtime must log
    the winner and the output must equal the default variant's bytes."""
    from repro_torch.core.calibrate import _host

    pe = next(p for p in sorted(session.runtime.pes, key=lambda p: p.name)
              if p.kind == kind)
    session.runtime.reset_stats()
    fut = session.submit(tun.op, list(ins), pin=pe.name,
                         name="dispatch_check")
    out = fut.result(timeout=300)
    session.barrier()
    log = [v for (o, _k, v) in session.runtime.variant_log if o == tun.op]
    space = session.context.spaces[pe.location]
    ref = _host(tun.fn([space.ingest(a) for a in ins])[0])  # default params
    return {
        "op": tun.op,
        "pe": pe.name,
        "winner": win["variant"],
        "variant_log": log,
        "selected_winner": win["variant"] in log,
        "bit_identical": bool(np.asarray(out).tobytes() == ref.tobytes()),
    }


def run_autotune_gate(*, smoke: bool, device=None) -> dict:
    """Part B: live autotune on a CPU PE and (on the card) a ``gpu0``
    PE; ≥1 non-default winner with speedup ≥ 1, winner dispatch +
    bit-identity through the calibrated session for each PE kind."""
    from repro_torch.core.api import OpRegistry, Session
    from repro_torch.core.autotune import autotune, tunables, tuned_summary
    from repro_torch.core.calibrate import DEFAULT_VARIANT
    from repro_torch.core.runtime import resolve_device
    from repro_torch.kernels import _build

    on_card = resolve_device(device).type == "cuda"
    if on_card:
        _build.library()  # nvcc before the first timed kernel
    ladder = AUTOTUNE_LADDER_SMOKE if smoke else AUTOTUNE_LADDER
    reg = OpRegistry()
    session = Session.emulated(n_cpu=1,
                               accelerators=("gpu0",) if on_card else (),
                               registry=reg, device=device)
    try:
        table = autotune(session, nbytes=ladder, k=5, warmup=2, seed=0)
        tuned = tuned_summary(table)
        nondefault = {key: win for key, win in tuned.items()
                      if win["variant"] != DEFAULT_VARIANT}
        winner_speedup = max(
            (win["speedup"] for win in nondefault.values()), default=1.0)

        # dispatch check per PE kind: the best non-default winner of a
        # single-output op runs through the calibrated session
        dispatch = {}
        single_out = {t.op: t for t in tunables() if t.op != "rg_lru"}
        for kind in sorted({pe.kind for pe in session.runtime.pes}):
            cands = [(key, win) for key, win in nondefault.items()
                     if key.split("/")[0] in single_out
                     and key.split("/")[1] == kind]
            if not cands:
                continue
            key, win = max(cands, key=lambda kv: kv[1]["speedup"])
            op_name, _kind, bucket = key.split("/")
            tun = single_out[op_name]
            ins = _inputs_for_bucket(tun, ladder, bucket)
            dispatch[kind] = _dispatch_check(session, tun, win, kind, ins)
    finally:
        session.close()

    emit(
        "calibrate_autotune", winner_speedup,
        f"nondefault_winners={len(nondefault)};"
        f"winners={sorted(w['variant'] for w in nondefault.values())};"
        f"ladder={list(ladder)}",
    )
    return {
        "ladder": list(ladder),
        "cells": len(table),
        "tuned_winners": tuned,
        "nondefault_winners": len(nondefault),
        "winner_speedup": winner_speedup,
        "dispatch": dispatch,
        "skipped_ops": table.meta.get("skipped_ops", []),
    }


def run_calibrate(*, json_path, smoke: bool, device=None) -> dict:
    plan = run_plan_gate(device)
    tune = run_autotune_gate(smoke=smoke, device=device)
    base = baseline_plan()

    rec = {
        "bench": "calibrate",
        "plan": plan,
        "plan_equals_reference": plan == base,
        "autotune": tune,
        "gate": {
            "calibrated_vs_prior_makespan":
                plan["calibrated_vs_prior_makespan"],
            "nondefault_winners": min(tune["nondefault_winners"], 1),
            "winner_speedup": min(tune["winner_speedup"], 1.0),
        },
    }

    if smoke:
        assert plan == base, (
            f"part A differs from the reference's baseline {BASELINE}: "
            f"{plan} != {base}")
        assert tune["nondefault_winners"] >= 1, (
            f"autotuning found no non-default variant winner: "
            f"{tune['tuned_winners']}"
        )
        assert tune["winner_speedup"] >= 1.0, tune
        for kind, check in tune["dispatch"].items():
            assert check["selected_winner"], (kind, check)
            assert check["bit_identical"], (kind, check)
        print(
            f"calibrate smoke: OK (plan ratio "
            f"{plan['calibrated_vs_prior_makespan']!r} = reference, "
            f"{tune['nondefault_winners']} non-default winner(s), "
            f"best speedup {tune['winner_speedup']:.2f}x, dispatch checked "
            f"on {sorted(tune['dispatch'])})", flush=True)

    if json_path:
        Path(json_path).write_text(json.dumps(rec, indent=1))
        print(f"wrote {json_path}", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small run with plan-equality + winner asserts")
    ap.add_argument("--json", default="BENCH_calibrate.json",
                    help="machine-readable output path ('' to skip)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    run_calibrate(json_path=args.json or None, smoke=args.smoke)


if __name__ == "__main__":
    main()
