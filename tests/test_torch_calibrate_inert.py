"""ROADMAP C.11, pinned as it stands: on a cpu PE the port's tuned ops run
their plain versions, which ignore the launch parameter, yet calibration
still names a winner among the candidates by their timings.

The timer is replaced so the test does not depend on the host's noise:
``block_rows32`` is made to time faster than the other ``fft_pallas``
candidates, whose outputs are bit-identical because they do the same
work.  The table then names it the winner with a speedup above 1.  When
the port decides how a cpu PE should treat inert parameters, this test
is where that change shows.
"""

import numpy as np
import torch

from repro_torch.core import calibrate as cal
from repro_torch.core.api import OpRegistry, Session
from repro_torch.core.autotune import register_tunables
from repro_torch.core.calibrate import DEFAULT_VARIANT
from repro_torch.kernels.fft import ops as fft_ops

torch.set_num_threads(1)


def test_fft_block_rows_is_inert_on_the_cpu():
    """The plain FFT a cpu PE runs gives the same bits for every
    ``block_rows``: the candidates do the same work."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(16, 1024))
                          + 1j * rng.normal(size=(16, 1024)))
                         .astype(np.complex64))
    base = fft_ops.fft(x)
    for rows in (32, 128):
        assert torch.equal(fft_ops.fft(x, block_rows=rows), base)


def test_cpu_pe_names_a_winner_at_an_inert_parameter(monkeypatch):
    real = cal._measure_thread

    def timed(fn, ins, params, *, k, warmup):
        _, outs = real(fn, ins, params, k=1, warmup=1)
        return (1e-3 if params.get("block_rows") == 32 else 2e-3), outs

    monkeypatch.setattr(cal, "_measure_thread", timed)
    reg = OpRegistry()
    register_tunables(reg, kinds=("cpu",))
    session = Session.emulated(n_cpu=1, accelerators=(), registry=reg,
                               device="cpu")
    try:
        table = cal.calibrate(session, ops=["fft_pallas"],
                              nbytes=[16 << 10])
    finally:
        session.close()
    cells = dict(table.cells())
    alts = [c for key, c in cells.items()
            if key.startswith("fft_pallas/") and DEFAULT_VARIANT not in key]
    assert len(alts) == 2 and all(c["identical"] is True for c in alts)
    (key, win), = [(key, w) for key, w in table.winners()
                   if key.startswith("fft_pallas/cpu/")]
    assert win["variant"] == "block_rows32"
    assert win["speedup"] == 2.0
