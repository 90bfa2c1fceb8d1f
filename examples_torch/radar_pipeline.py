"""Radar applications end-to-end (paper Table 2, shrunk) on the
streaming session API (the port of ``examples/radar_pipeline.py``): RC,
PD and SAR chains submitted through a Session on GPU-only and
3CPU+1GPU configurations, reference vs RIMMS — plus multi-client
streaming: concurrent submitter threads sharing one session,
windowed-HEFT placement, and the modeled Gantt.

Accelerator spaces live on ``--device`` (default CUDA; ``cpu`` runs on
CPU tensors).

Run:  PYTHONPATH=src python examples_torch/radar_pipeline.py [--device cpu]
"""

import argparse
import functools
import threading

from repro_torch.apps.radar import (build_pd, build_rc, build_sar,
                                    make_session, submit_2fzf)


def bench(builder, policy, n_cpu, accelerators, device=None):
    """Run one app's task build through a session (tasks stream in
    submission order; round_robin keeps the paper's placement)."""
    session = make_session(policy=policy, scheduler="round_robin",
                           n_cpu=n_cpu, accelerators=accelerators,
                           device=device)
    # App builders produce (buffers, Task lists) against the context;
    # stream the tasks through the session via wrapped buffers.
    bufs, tasks = builder(session.context)
    for t in tasks:
        session.submit(t.op, t.inputs, out=t.outputs, pin=t.pin,
                       name=t.name, **t.params)
    session.barrier()  # warm-up round
    session.ledger.reset()
    t0 = session.report()["wall_s"]
    for t in tasks:
        session.submit(t.op, t.inputs, out=t.outputs, pin=t.pin,
                       name=t.name, **t.params)
    session.barrier()
    wall = session.report()["wall_s"] - t0
    snap = session.ledger.snapshot()
    session.close()
    session.runtime.close()
    return wall, snap


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="where accelerator spaces live (default: CUDA; "
                         "'cpu' runs on CPU tensors)")
    device = ap.parse_args().device
    apps = [
        ("RC ", build_rc),
        ("PD ", functools.partial(build_pd, ways=32, n=128)),
        ("SAR", functools.partial(build_sar, scale=16)),
    ]
    print(f"{'app':4s} {'config':10s} {'ref ms':>9s} {'rimms ms':>9s} "
          f"{'spdup':>6s} {'copies':>12s} {'modeled spdup':>13s}")
    for name, builder in apps:
        for cfg_name, n_cpu, accs in (("gpu-only", 0, ("gpu0",)),
                                      ("3cpu-1gpu", 3, ("gpu0",))):
            ref_w, ref_l = bench(builder, "reference", n_cpu, accs, device)
            rim_w, rim_l = bench(builder, "rimms", n_cpu, accs, device)
            print(
                f"{name:4s} {cfg_name:10s} {ref_w*1e3:9.2f} {rim_w*1e3:9.2f} "
                f"{ref_w/max(rim_w,1e-12):5.2f}x "
                f"{ref_l['total_copies']:5d}->{rim_l['total_copies']:<5d} "
                f"{ref_l['modeled_seconds']/max(rim_l['modeled_seconds'],1e-12):12.2f}x"
            )

    # --- multi-client streaming: 4 clients share one 2-accelerator
    # session; windowed HEFT places the interleaved chains --------------
    print("\n4 concurrent clients x 4 radar chains on one 2-accelerator "
          "session (windowed HEFT):")
    session = make_session(policy="rimms", scheduler="heft", n_cpu=0,
                           accelerators=("gpu0", "gpu1"), device=device)

    def client(c):
        for k in range(4):
            bufs = submit_2fzf(session, 2048, seed=c * 10 + k,
                               tag=f"_c{c}k{k}")
            bufs["out"].result()  # each client blocks only on its own work

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    session.barrier()
    rep = session.report()
    print(f"  {rep['n_tasks']} tasks streamed, modeled makespan "
          f"{rep['makespan_model']*1e3:.3f} ms, per-PE busy: "
          + ", ".join(f"{pe}={s*1e3:.3f}ms"
                      for pe, s in sorted(rep["per_pe_busy_model_s"].items())))
    print("  stream schedule (modeled Gantt):")
    print(rep["timeline"].gantt(64))
    session.close()
    session.runtime.close()


if __name__ == "__main__":
    main()
