"""Quickstart: the RIMMS streaming session API on a CPU + GPU (the port
of ``examples/quickstart.py``).

The session is the primary entry point: ``@rimms.op`` kernels
register per-PE-kind variants, ``Session.malloc``/``Session.submit``
return BufferFutures that extend a live task DAG, and the runtime owns
placement, movement and completion — ``result()`` is the only sync
point.  The ledger shows the eliminated copies vs the host-owned
reference flow (paper Fig 1).

Accelerator spaces live on ``--device`` (default CUDA; ``cpu`` runs the
same API on CPU tensors).

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.apps.radar import make_session, submit_2fzf
from repro_torch.core import api as rimms


# A custom op: one decorator per PE-kind variant — no register_kernel,
# no Task lists.  (The radar import above already registered fft/ifft/zip
# variants the same way.)  A cpu PE holds numpy arrays, a gpu PE torch
# tensors on its device.
@rimms.op("scale", kinds="cpu")
def scale(ins, *, k=2.0):
    return (ins[0] * k).astype(np.complex64)


@rimms.op("scale", kinds="gpu")
def scale_gpu(ins, *, k=2.0):
    return ins[0] * k


def run_policy(policy: str, device=None):
    """One 2FZF radar chain streamed through a session under ``policy``
    on the paper's ACC-ACC scenario (FFT engine + ZIP engine, no CPU
    PE); returns (output, ledger snapshot, placements)."""
    with make_session(policy=policy, scheduler="round_robin", n_cpu=0,
                      accelerators=("fft_acc0", "zip_acc0"),
                      device=device) as s:
        bufs = submit_2fzf(s, 256, seed=42)
        out = bufs["out"].result()  # the only sync point
        snapshot = s.ledger.snapshot()
        placements = list(s.runtime.task_log)
    s.runtime.close()
    return out, snapshot, placements


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="where accelerator spaces live (default: CUDA; "
                         "'cpu' runs on CPU tensors)")
    device = ap.parse_args().device

    # --- the session API tour --------------------------------------------
    with make_session(accelerators=("gpu0",), device=device) as s:
        M, N = 8, 128
        inp = s.malloc((M * N,), np.complex64)     # hete_Malloc
        inp.hete.fragment(N)                       # fragment into M inputs
        inp.hete[3].data[:] = 1.0 + 0j             # indexed fragment access
        print(f"allocated {M}x{N} complex buffer, fragment 3 sum =",
              inp.hete[3].data.sum())

        sig = s.malloc((N,), np.complex64)
        sig.data[:] = np.exp(2j * np.pi * np.arange(N) * 4 / N)
        f = s.submit("fft", [sig])                 # deferred: returns a future
        g = s.submit("scale", [f], k=0.5)          # chains without waiting
        back = s.submit("ifft", [g])
        np.testing.assert_allclose(back.result(), 0.5 * sig.data, atol=1e-4)
        print("fft -> scale(custom op) -> ifft chain ✓ "
              f"({len(s.runtime.task_log)} tasks streamed)")

        inp.free()                                 # free-after-last-use
        sig.free()
    s.runtime.close()

    # --- reference vs RIMMS on the 2FZF radar chain ----------------------
    results, copies = {}, {}
    for policy in ("reference", "rimms"):
        out, ledger, placements = run_policy(policy, device)
        results[policy] = out
        copies[policy] = ledger["total_copies"]
        print(f"\n[{policy:9s}] copies={ledger['total_copies']} "
              f"bytes={ledger['total_bytes']} "
              f"modeled={ledger['modeled_seconds']*1e6:.1f}us")
        for pair, n in ledger["by_pair"].items():
            print(f"    {pair}: {n}")
        print(f"    placements: {placements}")
    np.testing.assert_allclose(results["reference"], results["rimms"],
                               atol=1e-4)
    assert copies["rimms"] < copies["reference"], copies
    print("\nreference == rimms output ✓ (fewer copies, same math)")


if __name__ == "__main__":
    main()
