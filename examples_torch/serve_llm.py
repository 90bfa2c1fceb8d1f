"""Serving example: multi-tenant continuous batching on the RIMMS Session,
on the GPU (the port of ``examples/serve_llm.py``).

A small dense LM serves two tenants' prompt streams through
:class:`repro_torch.serve.session_engine.SessionServeEngine`: every
tenant is a QoS client with its own decode weight and KV page quota, KV
pages live in runtime-managed page-group buffers, and the engine reports
per-tenant decode latency percentiles + SLO burn rates from the
deterministic QoS replay.  ``--legacy`` runs the same workload through
the hand-managed :class:`repro_torch.serve.engine.ServeEngine` instead —
both engines generate bit-identical token streams.

Run:  PYTHONPATH=src python examples_torch/serve_llm.py [--legacy]
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.runtime import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.session_engine import SessionServeEngine


def make_requests(vocab: int, max_new: int):
    rng = np.random.default_rng(0)
    lens = (4, 7, 3, 9, 5, 6, 4, 8)
    return [(rng.integers(1, vocab, size=n).tolist(), max_new)
            for n in lens]


def serve_legacy(cfg, params, work, device):
    eng = ServeEngine(cfg, params, max_batch=4, page_size=16, num_pages=256,
                      max_pages_per_seq=16, allocator="bitset", device=device)
    reqs = [eng.submit(p, m) for p, m in work]
    eng.run()
    print(f"page pool: {eng.pool.free_pages} free of {eng.pool.num_pages} "
          f"(fragment-allocs={eng.pool.fragment_allocs}, "
          f"fallbacks={eng.pool.fallback_allocs})")
    return reqs


def serve_session(cfg, params, work, device):
    with SessionServeEngine(cfg, params, max_batch=4, page_size=16,
                            num_pages=256, max_pages_per_seq=16,
                            allocator="bitset", device=device) as eng:
        # two tenants: "pro" gets 4x the decode weight and most of the
        # KV page budget; "free" runs under a tight quota.
        eng.tenant("pro", weight=4.0, quota_pages=192,
                   slo_latency_s=1.0, slo_target=0.99)
        eng.tenant("free", weight=1.0, quota_pages=32,
                   slo_latency_s=1.0, slo_target=0.99)
        reqs = [eng.submit(p, m, tenant=("pro" if i % 2 == 0 else "free"))
                for i, (p, m) in enumerate(work)]
        eng.run()
        rep = eng.qos_report()
        for name in ("pro", "free"):
            pct = rep["latency_percentiles"][name]
            slo = rep["slo"][name]
            print(f"  tenant {name}: {pct['count']} decode substeps, "
                  f"modeled p95 {pct['p95'] * 1e6:.1f}us, "
                  f"slo burn rate {slo['burn_rate']:.3f}")
        print(f"  kv spill bytes: {eng.kv.spill_bytes()}")
    return reqs


def main(argv=None, *, device=None):
    """``device``: ``None`` is CUDA (raising without it); the tests pass
    ``"cpu"``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--legacy", action="store_true",
                    help="use the hand-managed ServeEngine instead of "
                         "the Session-backed engine")
    ap.add_argument("--tokens", type=int, default=8,
                    help="max new tokens per request")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = dataclasses.replace(
        get_config("llama3_8b").smoke(), name="serve-demo", dtype="float32"
    )
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    work = make_requests(cfg.vocab, args.tokens)

    t0 = time.perf_counter()
    if args.legacy:
        reqs = serve_legacy(cfg, params, work, dev)
    else:
        reqs = serve_session(cfg, params, work, dev)
    wall = time.perf_counter() - t0

    assert all(r.done for r in reqs)
    total_new = sum(len(r.generated) for r in reqs)
    eng_name = "legacy" if args.legacy else "session"
    print(f"served {len(reqs)} requests / {total_new} tokens on the "
          f"{eng_name} engine in {wall:.2f}s "
          f"({total_new / wall:.1f} tok/s on {dev.type.upper()})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt={r.prompt} -> {r.generated}")
    return reqs


if __name__ == "__main__":
    main()
