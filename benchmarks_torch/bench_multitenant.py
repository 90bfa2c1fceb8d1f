"""Multi-tenant QoS: 1 heavy + 3 light clients on one session (the
port's ``benchmarks/bench_multitenant.py``).

The acceptance benchmark for the QoS subsystem.  Three *light* clients
each stream ``K`` radar 2FZF chains in a closed loop (submit a chain,
wait for its result, submit the next) while one *heavy* client floods
``H`` chains open-loop against the SAME session on 2 emulated
accelerators.  The heavy client runs under a small backpressure window
and a low DRR weight; the lights keep default weight with a
one-chain-in-flight window.  Three claims are checked:

* **bounded interference**: the light clients' p95 per-chain *modeled*
  latency in the mix stays ≤ 2× their solo run (the same three lights
  without the heavy tenant).  Latencies come from the deterministic
  QoS replay (:func:`repro_torch.core.qos.fair_replay` via
  ``Session.qos_report``), which re-enacts windows + weighted DRR
  admission in virtual time — so the metric depends only on each
  client's own submission order, never on thread interleaving, and is
  byte-identical across runs and machines;
* **bit-identical per chain**: every light chain's output in the mix
  equals, bitwise, the same chain in the solo run (same seeds — QoS
  changes *when* work runs, never *what* it computes);
* **fairness**: ``ledger.fairness_report()`` over the three equal-weight
  light clients reports a Jain's index ≥ 0.8 (they demand equal work,
  so equal service ⇒ index ≈ 1.0).

An *unbounded* variant (heavy client with an effectively infinite
window and full weight — FCFS admission, the pre-QoS behaviour) is also
run for the report, to show the interference QoS removes.

Emits ``BENCH_multitenant.json`` for the perf-regression gate
(``benchmarks_torch/check_regression.py``); the record carries
per-metric ``gate_tolerances`` the gate honours.  Constants, seeds and
pins are the reference's, so the gated metrics equal its committed
baselines exactly.

Accelerator spaces live on ``--device`` (default CUDA; ``cpu`` runs on
CPU tensors).  On the card both ``gpu0`` and ``gpu1`` are ``cuda:0``
with an arena each, so every fft/ifft/zip task launches the port's FFT
or ZIP kernel: a chain is three FFT launches and one ZIP launch.  The
light chains' outputs come back through ``result()`` as host arrays and
are compared there.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_multitenant [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import threading
from pathlib import Path

import numpy as np

from .common import emit

ACCELERATORS = ("gpu0", "gpu1")
N_LIGHTS = 3
LIGHT_CHAINS = 8
HEAVY_CHAINS = 64
N = 1 << 13
LIGHT_WINDOW = 4  # one chain in flight: the closed-loop pacing
HEAVY_WINDOW = 4
HEAVY_WEIGHT = 0.25
GLOBAL_WINDOW = 12  # the shared admission budget the DRR weights split
# Latency SLOs: the lights declare a loose objective no
# modeled latency can violate; the heavy tenant declares one below the
# 20us modeled launch floor, so every task violates it — the benchmark
# deterministically exercises both the clean and the breached paths of
# the burn-rate monitor.
LIGHT_SLO_LATENCY_S = 60.0
HEAVY_SLO_LATENCY_S = 10e-6
SLO_TARGET = 0.99


def _chain_seed(client: int, chain: int) -> int:
    return 5000 + client * 131 + chain


def _light_pin(c: int, k: int, accs) -> str:
    # lights 0/1 each own one accelerator; light 2 alternates per chain
    return accs[k % len(accs)] if c == 2 else accs[c % len(accs)]


def _tenant_case(*, n: int, light_chains: int, heavy_chains: int,
                 heavy_window: int, heavy_weight: float, accs,
                 include_heavy: bool, global_window=GLOBAL_WINDOW,
                 device=None) -> dict:
    """Run the client mix against one session; returns per-chain light
    outputs/latencies (from the deterministic QoS replay), fairness, and
    ledger evidence."""
    from repro_torch.apps.radar import make_session, submit_2fzf

    session = make_session(policy="rimms", scheduler="round_robin",
                           n_cpu=0, accelerators=accs,
                           global_window=global_window, device=device)
    light_names = [f"light{c}" for c in range(N_LIGHTS)]
    for name in light_names:
        session.client(name, weight=1.0, window=LIGHT_WINDOW,
                       slo_latency_s=LIGHT_SLO_LATENCY_S,
                       slo_target=SLO_TARGET)
    if include_heavy:
        session.client("heavy", weight=heavy_weight, window=heavy_window,
                       slo_latency_s=HEAVY_SLO_LATENCY_S,
                       slo_target=SLO_TARGET)

    outs: dict = {}
    nodes: dict = {}
    errors: list = []

    def light(c: int) -> None:
        # closed loop: one chain in flight, next submitted after result()
        try:
            rows, ids = [], []
            for k in range(light_chains):
                pe = _light_pin(c, k, accs)
                bufs = submit_2fzf(session, n, pins=(pe,) * 4,
                                   seed=_chain_seed(c, k), tag=f"_l{c}k{k}")
                rows.append(bufs["out"].result(timeout=300))
                ids.append((bufs["fa"].node, bufs["out"].node))
            outs[c] = rows
            nodes[c] = ids
        except BaseException as e:  # pragma: no cover - surfaced below
            errors.append(e)

    def heavy() -> None:
        # open loop: submit everything ASAP; backpressure paces it
        try:
            for k in range(heavy_chains):
                pe = accs[k % len(accs)]
                submit_2fzf(session, n, pins=(pe,) * 4,
                            seed=_chain_seed(9, k), tag=f"_h{k}")
        except BaseException as e:  # pragma: no cover - surfaced below
            errors.append(e)

    session.ledger.reset()
    threads = [threading.Thread(target=light, args=(c,), name=f"light{c}")
               for c in range(N_LIGHTS)]
    if include_heavy:
        threads.append(threading.Thread(target=heavy, name="heavy"))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    session.barrier()
    rep = session.report()
    qrep = session.qos_report()
    finish, release = qrep["finish_model"], qrep["release_model"]
    lats = {
        c: [finish[out_i] - release[fa_i] for fa_i, out_i in nodes[c]]
        for c in range(N_LIGHTS)
    }
    fairness = session.ledger.fairness_report(clients=light_names)
    snap = session.ledger.snapshot()
    session.close()
    divergence = session.runtime.divergence.table()
    session.runtime.close()
    return {
        "slo": qrep["slo"],
        "divergence": divergence,
        "wall_s": rep["wall_s"],
        "makespan_model": qrep["makespan_model"],
        "n_tasks": rep["n_tasks"],
        "n_completed": rep["n_completed"],
        "copies": snap["total_copies"],
        "jain_lights": fairness["jain_index"],
        "stall_s": {name: snap["client_tasks"].get(name, 0) and
                    fairness["clients"][name]["stall_s"]
                    for name in fairness["clients"]},
        # per-client per-*task* modeled-latency percentiles from the
        # session's histogram registry — a different quantity
        # from the per-*chain* p95 the interference gate uses
        "latency_percentiles": qrep["latency_percentiles"],
        "_out": outs,
        "_lat": lats,
    }


def _p95(lats: dict) -> float:
    flat = [v for row in lats.values() for v in row]
    return float(np.percentile(np.asarray(flat, dtype=np.float64), 95))


def run_multitenant(*, n: int, light_chains: int, heavy_chains: int,
                    json_path, smoke: bool, device=None) -> dict:
    accs = ACCELERATORS
    kw = dict(n=n, light_chains=light_chains, heavy_chains=heavy_chains,
              accs=accs, device=device)
    solo = _tenant_case(heavy_window=HEAVY_WINDOW,
                        heavy_weight=HEAVY_WEIGHT, include_heavy=False, **kw)
    mix = _tenant_case(heavy_window=HEAVY_WINDOW,
                       heavy_weight=HEAVY_WEIGHT, include_heavy=True, **kw)
    # pre-QoS behaviour: FCFS admission, nothing bounds the heavy tenant
    unbounded = _tenant_case(heavy_window=4 * heavy_chains,
                             heavy_weight=1.0, include_heavy=True,
                             global_window=None, **kw)

    p95_solo, p95_mix = _p95(solo["_lat"]), _p95(mix["_lat"])
    p95_unbounded = _p95(unbounded["_lat"])
    ratio = p95_mix / max(p95_solo, 1e-12)
    ratio_unbounded = p95_unbounded / max(p95_solo, 1e-12)
    identical = all(
        np.array_equal(mix["_out"][c][k], solo["_out"][c][k])
        for c in range(N_LIGHTS) for k in range(light_chains)
    )

    emit(
        "multitenant_mix", mix["wall_s"] * 1e6,
        f"light_p95_ms={p95_mix * 1e3:.3f};x_solo={ratio:.2f};"
        f"jain={mix['jain_lights']:.3f};copies={mix['copies']}",
    )
    emit(
        "multitenant_solo", solo["wall_s"] * 1e6,
        f"light_p95_ms={p95_solo * 1e3:.3f}",
    )
    emit(
        "multitenant_unbounded", unbounded["wall_s"] * 1e6,
        f"light_p95_ms={p95_unbounded * 1e3:.3f};"
        f"x_solo={ratio_unbounded:.2f}",
    )

    strip = ("_out", "_lat", "divergence")
    rec = {
        "bench": "multitenant",
        "params": {
            "n": n, "light_chains": light_chains,
            "heavy_chains": heavy_chains, "n_lights": N_LIGHTS,
            "light_window": LIGHT_WINDOW, "heavy_window": HEAVY_WINDOW,
            "heavy_weight": HEAVY_WEIGHT, "global_window": GLOBAL_WINDOW,
            "accelerators": list(accs),
        },
        "mix": {k: v for k, v in mix.items() if k not in strip},
        "solo": {k: v for k, v in solo.items() if k not in strip},
        "unbounded": {k: v for k, v in unbounded.items() if k not in strip},
        "light_p95_model_s": {"solo": p95_solo, "mix": p95_mix,
                              "unbounded": p95_unbounded},
        "light_p95_over_solo": ratio,
        "light_p95_over_solo_unbounded": ratio_unbounded,
        "bit_identical": bool(identical),
        # Wall/modeled calibration table + per-tenant SLO burn rates
        # from the mix case.
        "divergence": mix["divergence"],
        "slo": mix["slo"],
        # Regression-gated metrics: all from the deterministic QoS
        # replay (virtual admission + modeled execution), so they are
        # exact across runs and machines.
        "gate": {
            "light_p95_model_s": p95_mix,
            "light_p95_over_solo": ratio,
            "mix_makespan_model": mix["makespan_model"],
            "copies": mix["copies"],
        },
        # Per-metric gate tolerances: the ratio gets
        # headroom; everything else uses the gate default.
        "gate_tolerances": {"light_p95_over_solo": 0.25},
    }

    if smoke:
        # SLO burn rates: the lights' loose objective is never
        # violated; the heavy tenant's sub-launch-floor objective is
        # violated by every task — both deterministic, from the replay.
        slo = mix["slo"]
        for c in range(N_LIGHTS):
            s = slo[f"light{c}"]
            assert s["violations"] == 0 and not s["breached"], (c, s)
        hs = slo["heavy"]
        assert hs["violations"] == hs["tasks"] > 0, hs
        assert hs["breached"] and hs["burn_rate"] > 1.0, hs
        # Per-client histogram percentiles: every tenant must
        # report ordered, positive per-task modeled latency quantiles,
        # with one sample per task it completed.
        pct = mix["latency_percentiles"]
        expect = {f"light{c}" for c in range(N_LIGHTS)} | {"heavy"}
        assert expect <= set(pct), (
            f"missing per-client percentiles: {expect - set(pct)}"
        )
        for name in sorted(expect):
            s = pct[name]
            assert 0.0 < s["p50"] <= s["p95"] <= s["p99"], (name, s)
        n_light_tasks = sum(pct[f"light{c}"]["count"]
                            for c in range(N_LIGHTS))
        assert n_light_tasks + pct["heavy"]["count"] == mix["n_tasks"], (
            "histogram sample counts don't cover the task population"
        )
        assert identical, "light chains differ between mix and solo runs"
        assert mix["n_completed"] == mix["n_tasks"], (
            f"heavy tenant starved: {mix['n_completed']}/{mix['n_tasks']}"
        )
        assert ratio <= 2.0, (
            f"light-client p95 modeled latency {ratio:.2f}x solo "
            f"(acceptance: <=2x; unbounded FCFS gives "
            f"{ratio_unbounded:.2f}x)"
        )
        assert mix["jain_lights"] >= 0.8, (
            f"Jain's index over equal-weight light clients only "
            f"{mix['jain_lights']:.3f} (acceptance: >=0.8)"
        )
        print(f"multitenant smoke: OK (light p95 {ratio:.2f}x solo vs "
              f"{ratio_unbounded:.2f}x unbounded, jain "
              f"{mix['jain_lights']:.3f}, bit-identical per chain)",
              flush=True)

    if json_path:
        Path(json_path).write_text(json.dumps(rec, indent=1))
        print(f"wrote {json_path}", flush=True)
    return rec


def run(n: int = N, light_chains: int = LIGHT_CHAINS,
        heavy_chains: int = HEAVY_CHAINS, json_path=None,
        device=None) -> None:
    run_multitenant(n=n, light_chains=light_chains,
                    heavy_chains=heavy_chains, json_path=json_path,
                    smoke=False, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small CI run with latency-bound + bit-identity "
                         "+ fairness asserts")
    ap.add_argument("--json", default="BENCH_multitenant.json",
                    help="machine-readable output path ('' to skip)")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--light-chains", type=int, default=None)
    ap.add_argument("--heavy-chains", type=int, default=None)
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="export + lint a Perfetto trace of the run")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="write a METRICS_*.json divergence table "
                         "(requires --trace-dir)")
    ap.add_argument("--device", default=None,
                    help="where accelerator spaces live (default: CUDA; "
                         "'cpu' runs on CPU tensors)")
    args = ap.parse_args(argv)
    n = args.n or (1 << 12 if args.smoke else N)
    light_chains = args.light_chains or (4 if args.smoke else LIGHT_CHAINS)
    heavy_chains = args.heavy_chains or (24 if args.smoke else HEAVY_CHAINS)
    print("name,us_per_call,derived")
    from .common import tracing

    with tracing(args.trace_dir, "multitenant", metrics_dir=args.metrics_dir):
        run_multitenant(n=n, light_chains=light_chains,
                        heavy_chains=heavy_chains,
                        json_path=args.json or None, smoke=args.smoke,
                        device=args.device)


if __name__ == "__main__":
    main()
