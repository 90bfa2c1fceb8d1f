"""Continuous-batching LLM serving gate, on the port (PyTorch, CUDA).

The port of ``benchmarks/bench_serve.py``: the same constants, workload
and asserts, with ``device=`` (``None`` is CUDA; the tests pass
``"cpu"``).  The acceptance benchmark for the Session-backed serving
subsystem
(:class:`repro_torch.serve.session_engine.SessionServeEngine`): ``N_USERS``
(>= 100) simulated closed-loop users — each submits a request, waits for
its completion, then submits the next — split across 1 *heavy* + 3
*light* tenants on one emulated accelerator.  Every tenant is a QoS
client; KV pages live in runtime-managed page-group buffers
(:class:`repro_torch.core.kv_manager.KVManager`).  Four runs, four claims:

* **mix** (the headline): aggregate modeled token throughput
  (``tokens_per_s_model``) and the light tenants' p95 modeled decode
  latency, both from the deterministic QoS replay — exact across runs
  and machines;
* **solo**: the light users alone; the gate bounds
  ``decode_p95_ratio_vs_solo`` — how much the heavy tenant may stretch
  light-tenant decode latency;
* **pressure**: the same mix under a device arena smaller than the KV
  pool — cold page groups must spill to host through the runtime's
  eviction/coherence path (``spill_bytes > 0``) with **bit-identical**
  tokens (memory pressure changes *where* KV lives, never *what* is
  generated);
* **legacy**: the same workload through the hand-managed
  :class:`repro_torch.serve.engine.ServeEngine` — every request's token
  stream must match bitwise (the runtime manages the memory, the math
  is untouched).

Emits ``BENCH_serve.json``; the record carries ``gate_tolerances`` and
``gate_directions`` (throughput and spill gate lower bounds).  Its
``gate`` block holds modeled metrics and exact counts only, so it equals
``benchmarks/baselines/BENCH_serve.json``'s exactly.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_serve [--smoke]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from .common import emit

N_USERS = 104
REQS_PER_USER = 2
N_LIGHTS = 3
MAX_BATCH = 8
PAGE_SIZE = 8
NUM_PAGES = 128
MAX_PAGES_PER_SEQ = 4
PAGES_PER_GROUP = 16
ALLOCATOR = "nextfit"  # cycles page grabs across all groups → cold groups
PROMPT_LEN = (2, 9)  # [lo, hi)
MAX_NEW = (2, 7)
HEAVY_WEIGHT = 1.0
HEAVY_WINDOW = 4
LIGHT_WEIGHT = 4.0
LIGHT_WINDOW = 4
HEAVY_QUOTA_PAGES = 96  # generous: accounting exercised, no deferrals
LIGHT_SLO_LATENCY_S = 60.0  # loose objective — never violated
HEAVY_SLO_LATENCY_S = 10e-6  # below the launch floor — always violated
SLO_TARGET = 0.99
# Pressure arena: smaller than the 512 KiB KV pool (16 group buffers x
# 32 KiB) but larger than any one substep's referenced working set.
PRESSURE_ARENA_BYTES = 384 << 10
BIG_ARENA_BYTES = 64 << 20


def _tenant_of(u: int) -> str:
    return "heavy" if u % 2 == 0 else f"light{(u // 2) % N_LIGHTS}"


def make_workload(n_users: int, reqs_per_user: int, vocab: int, seed=0):
    """Per-user request lists [(prompt, max_new), ...] — deterministic."""
    rng = np.random.default_rng(seed)
    users = []
    for _ in range(n_users):
        reqs = []
        for _ in range(reqs_per_user):
            plen = int(rng.integers(*PROMPT_LEN))
            prompt = [int(t) for t in rng.integers(1, vocab, plen)]
            reqs.append((prompt, int(rng.integers(*MAX_NEW))))
        users.append(reqs)
    return users


def drive(submit, step, users) -> dict:
    """Closed-loop drive: each user keeps exactly one request in flight;
    the next is submitted the step after the previous completes.
    Returns ``{(user, req_index): generated_tokens}``."""
    nxt = [0] * len(users)
    cur: list = [None] * len(users)
    out: dict = {}

    def pump(u: int) -> None:
        if nxt[u] < len(users[u]):
            prompt, max_new = users[u][nxt[u]]
            cur[u] = (nxt[u], submit(u, prompt, max_new))
            nxt[u] += 1
        else:
            cur[u] = None

    for u in range(len(users)):
        pump(u)
    while any(c is not None for c in cur):
        step()
        for u in range(len(users)):
            if cur[u] is not None and cur[u][1].done:
                i, req = cur[u]
                out[(u, i)] = list(req.generated)
                pump(u)
    return out


def _session_case(cfg, params, users, *, include_heavy: bool,
                  arena_bytes: int, device) -> dict:
    from repro_torch.serve.session_engine import SessionServeEngine

    eng = SessionServeEngine(
        cfg, params, max_batch=MAX_BATCH, page_size=PAGE_SIZE,
        num_pages=NUM_PAGES, max_pages_per_seq=MAX_PAGES_PER_SEQ,
        pages_per_group=PAGES_PER_GROUP, allocator=ALLOCATOR,
        arena_bytes=arena_bytes, device=device,
    )
    for i in range(N_LIGHTS):
        eng.tenant(f"light{i}", weight=LIGHT_WEIGHT, window=LIGHT_WINDOW,
                   slo_latency_s=LIGHT_SLO_LATENCY_S, slo_target=SLO_TARGET)
    if include_heavy:
        eng.tenant("heavy", weight=HEAVY_WEIGHT, window=HEAVY_WINDOW,
                   quota_pages=HEAVY_QUOTA_PAGES,
                   slo_latency_s=HEAVY_SLO_LATENCY_S, slo_target=SLO_TARGET)

    active = [u for u in range(len(users))
              if include_heavy or _tenant_of(u) != "heavy"]
    sub_users = [users[u] for u in active]

    def submit(j, prompt, max_new):
        return eng.submit(prompt, max_new, tenant=_tenant_of(active[j]))

    t0 = time.perf_counter()
    out = drive(submit, eng.step, sub_users)
    wall = time.perf_counter() - t0
    # remap back to global user ids for cross-run comparison
    out = {(active[j], i): toks for (j, i), toks in out.items()}

    qrep = eng.qos_report()
    total_new = sum(len(t) for t in out.values())
    pct = qrep["latency_percentiles"]
    light_p95 = max(pct[f"light{i}"]["p95"] for i in range(N_LIGHTS))
    metrics = eng.session.metrics
    res = {
        "wall_s": wall,
        "makespan_model": qrep["makespan_model"],
        "total_new_tokens": total_new,
        "tokens_per_s_model": total_new / qrep["makespan_model"],
        "tokens_per_s_wall": total_new / wall,
        "light_decode_p95_model_s": light_p95,
        "latency_percentiles": pct,
        "slo": qrep["slo"],
        "fairness": qrep["fairness"],
        "spill_bytes": eng.kv.spill_bytes(),
        "kv_pages_resident": eng.kv.used_pages,
        "tokens_counter": int(
            metrics.counter("serve_tokens_generated").value),
        "requests_completed": int(
            metrics.counter("serve_requests_completed").value),
        "metrics_text": eng.session.metrics_text(),
        "_out": out,
    }
    eng.close()
    return res


def _legacy_case(cfg, params, users, device) -> dict:
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, max_batch=MAX_BATCH, page_size=PAGE_SIZE,
                      num_pages=NUM_PAGES,
                      max_pages_per_seq=MAX_PAGES_PER_SEQ,
                      allocator=ALLOCATOR, device=device)
    t0 = time.perf_counter()
    out = drive(lambda u, p, m: eng.submit(p, m), eng.step, users)
    wall = time.perf_counter() - t0
    total_new = sum(len(t) for t in out.values())
    return {"wall_s": wall, "total_new_tokens": total_new,
            "tokens_per_s_wall": total_new / wall, "_out": out}


def run_serve(*, n_users: int, reqs_per_user: int, json_path,
              smoke: bool, device=None) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import resolve_device
    from repro_torch.models import build_model

    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config("llama3_8b").smoke(),
                              name="serve-bench", dtype="float32")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(1))
    users = make_workload(n_users, reqs_per_user, cfg.vocab)

    mix = _session_case(cfg, params, users, include_heavy=True,
                        arena_bytes=BIG_ARENA_BYTES, device=dev)
    solo = _session_case(cfg, params, users, include_heavy=False,
                         arena_bytes=BIG_ARENA_BYTES, device=dev)
    pressure = _session_case(cfg, params, users, include_heavy=True,
                             arena_bytes=PRESSURE_ARENA_BYTES, device=dev)
    legacy = _legacy_case(cfg, params, users, dev)

    ratio = (mix["light_decode_p95_model_s"]
             / max(solo["light_decode_p95_model_s"], 1e-12))
    identical_legacy = mix["_out"] == legacy["_out"]
    identical_pressure = mix["_out"] == pressure["_out"]
    light_keys = {k for k in mix["_out"] if _tenant_of(k[0]) != "heavy"}
    identical_solo = all(mix["_out"][k] == solo["_out"][k]
                         for k in light_keys)

    emit("serve_mix", mix["wall_s"] * 1e6,
         f"tok_per_s_model={mix['tokens_per_s_model']:.1f};"
         f"tok_per_s_wall={mix['tokens_per_s_wall']:.1f};"
         f"light_p95_ms={mix['light_decode_p95_model_s'] * 1e3:.3f};"
         f"x_solo={ratio:.2f}")
    emit("serve_solo", solo["wall_s"] * 1e6,
         f"light_p95_ms={solo['light_decode_p95_model_s'] * 1e3:.3f}")
    emit("serve_pressure", pressure["wall_s"] * 1e6,
         f"spill_bytes={pressure['spill_bytes']};"
         f"identical={identical_pressure}")
    emit("serve_legacy", legacy["wall_s"] * 1e6,
         f"tok_per_s_wall={legacy['tokens_per_s_wall']:.1f};"
         f"identical={identical_legacy}")

    strip = ("_out", "metrics_text", "latency_percentiles")
    rec = {
        "bench": "serve",
        "device": str(dev),
        "params": {
            "n_users": n_users, "reqs_per_user": reqs_per_user,
            "n_lights": N_LIGHTS, "max_batch": MAX_BATCH,
            "page_size": PAGE_SIZE, "num_pages": NUM_PAGES,
            "max_pages_per_seq": MAX_PAGES_PER_SEQ,
            "pages_per_group": PAGES_PER_GROUP, "allocator": ALLOCATOR,
            "heavy_weight": HEAVY_WEIGHT, "light_weight": LIGHT_WEIGHT,
            "heavy_quota_pages": HEAVY_QUOTA_PAGES,
            "pressure_arena_bytes": PRESSURE_ARENA_BYTES,
        },
        "mix": {k: v for k, v in mix.items() if k not in strip},
        "solo": {k: v for k, v in solo.items() if k not in strip},
        "pressure": {k: v for k, v in pressure.items() if k not in strip},
        "legacy": {k: v for k, v in legacy.items() if k != "_out"},
        "decode_p95_ratio_vs_solo": ratio,
        "bit_identical_vs_legacy": bool(identical_legacy),
        "bit_identical_under_pressure": bool(identical_pressure),
        "slo": mix["slo"],
        # Regression-gated metrics — all modeled / exact-count, so they
        # are byte-identical across runs and machines.
        "gate": {
            "tokens_per_s_model": mix["tokens_per_s_model"],
            "light_decode_p95_model_s": mix["light_decode_p95_model_s"],
            "decode_p95_ratio_vs_solo": ratio,
            "mix_makespan_model": mix["makespan_model"],
            "pressure_spill_bytes": pressure["spill_bytes"],
        },
        "gate_tolerances": {"decode_p95_ratio_vs_solo": 0.25,
                            "pressure_spill_bytes": 0.9},
        # Throughput must not drop; pressure must keep spilling (the
        # generous tolerance only guards the eviction path staying live).
        "gate_directions": {"tokens_per_s_model": "min",
                            "pressure_spill_bytes": "min"},
    }

    if smoke:
        assert n_users >= 100, f"gate requires >=100 users, got {n_users}"
        n_reqs = n_users * reqs_per_user
        assert len(mix["_out"]) == n_reqs, (len(mix["_out"]), n_reqs)
        assert identical_legacy, (
            "session engine token streams differ from legacy ServeEngine"
        )
        assert identical_solo, (
            "light requests' tokens changed between mix and solo runs"
        )
        # Pressure: the eviction path must carry KV to host and back
        # without changing a single token.
        assert pressure["spill_bytes"] > 0, (
            f"no KV spill under a {PRESSURE_ARENA_BYTES}-byte arena"
        )
        assert identical_pressure, (
            "token streams changed under memory pressure"
        )
        assert mix["spill_bytes"] == 0, (
            "unexpected spill with an ample arena"
        )
        # Serving telemetry (PR-8 metrics): counters must agree with the
        # benchmark's own tally and be exported in Prometheus text.
        assert mix["tokens_counter"] == mix["total_new_tokens"]
        assert mix["requests_completed"] == n_reqs
        for name in ("serve_tokens_generated", "serve_requests_completed",
                     "serve_kv_pages_resident", "serve_kv_spill_bytes"):
            assert name in mix["metrics_text"], f"{name} not exported"
        # All pages back in the pool: only the pinned scratch page stays.
        assert mix["kv_pages_resident"] == 1, mix["kv_pages_resident"]
        # Per-tenant SLO burn rates from the deterministic replay: the
        # lights' loose objective holds; the heavy tenant's
        # sub-launch-floor objective is violated by every task.
        for i in range(N_LIGHTS):
            s = mix["slo"][f"light{i}"]
            assert s["violations"] == 0 and not s["breached"], (i, s)
        hs = mix["slo"]["heavy"]
        assert hs["violations"] == hs["tasks"] > 0 and hs["breached"], hs
        print(f"serve smoke: OK ({n_reqs} reqs from {n_users} users, "
              f"{mix['total_new_tokens']} tokens, "
              f"{mix['tokens_per_s_model']:.1f} modeled tok/s, light p95 "
              f"{ratio:.2f}x solo, pressure spilled "
              f"{pressure['spill_bytes']} B bit-identically)", flush=True)

    if json_path:
        Path(json_path).write_text(json.dumps(rec, indent=1))
        print(f"wrote {json_path}", flush=True)
    return rec


def run(n_users: int = N_USERS, reqs_per_user: int = REQS_PER_USER,
        json_path=None) -> None:
    run_serve(n_users=n_users, reqs_per_user=reqs_per_user,
              json_path=json_path, smoke=False)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI run with bit-identity + spill + telemetry "
                         "asserts")
    ap.add_argument("--json", default="BENCH_serve.json",
                    help="machine-readable output path ('' to skip)")
    ap.add_argument("--users", type=int, default=None)
    ap.add_argument("--reqs-per-user", type=int, default=None)
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="export + lint a Perfetto trace of the run")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="write a METRICS_serve.json divergence table "
                         "(requires --trace-dir)")
    args = ap.parse_args()
    n_users = args.users or N_USERS
    reqs = args.reqs_per_user or (1 if args.smoke else REQS_PER_USER)
    print("name,us_per_call,derived")
    from .common import tracing

    with tracing(args.trace_dir, "serve", metrics_dir=args.metrics_dir):
        run_serve(n_users=n_users, reqs_per_user=reqs,
                  json_path=args.json or None, smoke=args.smoke)


if __name__ == "__main__":
    main()
