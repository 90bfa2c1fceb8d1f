"""The port's ledger and timeline against the reference
(``tests/test_instrument.py``).

Every case of the reference's instrument tests runs here on
``repro_torch.core.instrument``: fresh_ledger semantics, the
snapshot/reset round trip and the Gantt transfer lanes.  Where a value is
computed, the JAX package computes it too from the same records and the
two must be equal: every ledger snapshot (counts, bytes, per-pair and
per-link records, modeled seconds) and every rendered Gantt text.
"""

import torch

from repro.core import instrument as jinstrument
from repro.core import locations as jlocations
from repro_torch.core.instrument import (
    Timeline,
    TimelineEvent,
    TransferEvent,
    TransferLedger,
    fresh_ledger,
)
from repro_torch.core.locations import BandwidthModel, Location

torch.set_num_threads(1)

HOST = Location("host", "cpu")
GPU = Location("device", "gpu0")


def _ledger():
    return TransferLedger(bandwidth_model=BandwidthModel())


JHOST = jlocations.Location("host", "cpu")
JGPU = jlocations.Location("device", "gpu0")


def _jax_ledger():
    return jinstrument.TransferLedger(
        bandwidth_model=jlocations.BandwidthModel())


def _round_trip_records(led, host, gpu):
    led.record(host, gpu, 1000)
    led.record(host, gpu, 1000)
    led.record(gpu, host, 500)
    led.record_eviction(gpu, 256, writeback_bytes=128, stall_s=0.25)
    led.record_flag_check(3)


# ---------------------------------------------------------------------------
# fresh_ledger: reset on entry, counts KEPT on exit (documented semantics)
# ---------------------------------------------------------------------------


def test_fresh_ledger_resets_on_entry_and_keeps_counts_on_exit():
    led = _ledger()
    led.record(HOST, GPU, 1024)
    assert led.total_copies == 1
    with fresh_ledger(led) as inner:
        assert inner is led
        assert led.total_copies == 0  # pre-existing counts cleared
        led.record(HOST, GPU, 2048)
        led.record(GPU, HOST, 512)
    # the block's evidence survives the exit — nothing is restored
    assert led.total_copies == 2
    assert led.total_bytes == 2560


def test_fresh_ledger_defaults_to_module_global():
    from repro_torch.core.instrument import ledger as global_ledger

    snap = global_ledger.snapshot()  # pre-experiment evidence, caller-kept
    with fresh_ledger() as led:
        assert led is global_ledger
        assert led.total_copies == 0
    assert snap["total_copies"] >= 0  # snapshot unaffected by the reset


# ---------------------------------------------------------------------------
# snapshot()/reset() round-trip
# ---------------------------------------------------------------------------


def test_snapshot_reset_round_trip():
    led = _ledger()
    _round_trip_records(led, HOST, GPU)
    snap = led.snapshot()
    jled = _jax_ledger()
    _round_trip_records(jled, JHOST, JGPU)
    assert snap == jled.snapshot()
    assert snap["total_copies"] == 3
    assert snap["total_bytes"] == 2500
    assert snap["by_pair"] == {"device:gpu0->host:cpu": 1,
                               "host:cpu->device:gpu0": 2}
    assert snap["per_link"]["host:cpu->device:gpu0"]["copies"] == 2
    assert snap["per_link"]["host:cpu->device:gpu0"]["bytes"] == 2000
    assert snap["total_evictions"] == 1
    assert snap["writeback_bytes"] == 128
    assert snap["flag_checks"] == 3

    led.reset()
    clean = led.snapshot()
    assert clean["total_copies"] == 0
    assert clean["total_bytes"] == 0
    assert clean["by_pair"] == {}
    assert clean["per_link"] == {}
    assert clean["total_evictions"] == 0
    assert clean["flag_checks"] == 0

    # counting resumes from zero after the reset
    led.record(HOST, GPU, 64)
    after = led.snapshot()
    jled.reset()
    jled.record(JHOST, JGPU, 64)
    assert after == jled.snapshot()
    assert after["total_copies"] == 1
    assert after["per_link"] == {
        "host:cpu->device:gpu0": {
            "copies": 1, "bytes": 64,
            "modeled_s": after["per_link"]["host:cpu->device:gpu0"]["modeled_s"],
        }
    }


# ---------------------------------------------------------------------------
# Timeline.gantt(): transfer lanes and overlap marks
# ---------------------------------------------------------------------------


def _compute(task, pe, t0, t1, event=TimelineEvent):
    return event(task=task, pe=pe, wall_start=0.0, wall_end=0.0,
                 model_start=t0, model_end=t1,
                 transfer_s=0.0, compute_s=t1 - t0)


def _jax_gantt(computes, transfers, width):
    """The JAX package's Gantt text for the same events."""
    tl = jinstrument.Timeline()
    for args in computes:
        tl.add(_compute(*args, event=jinstrument.TimelineEvent))
    for kw in transfers:
        tl.add_transfer(jinstrument.TransferEvent(**kw))
    return tl.gantt(width)


def test_gantt_renders_transfers_only_timeline():
    tl = Timeline()
    xfer = dict(link="host->gpu0", task="t0", nbytes=1024, model_start=0.0,
                model_end=0.5)
    tl.add_transfer(TransferEvent(**xfer))
    txt = tl.gantt(40)
    assert txt == _jax_gantt([], [xfer], 40)
    assert txt != "(empty timeline)"
    assert "host->gpu0" in txt
    assert "=" in txt  # link-busy lane rendered


def test_gantt_marks_overlap_within_a_lane_with_plus():
    tl = Timeline()
    computes = [("a", "gpu0", 0.0, 0.6),
                ("b", "gpu0", 0.4, 1.0)]  # b overlaps a on the same PE
    for args in computes:
        tl.add(_compute(*args))
    txt = tl.gantt(40)
    assert txt == _jax_gantt(computes, [], 40)
    assert "+" in txt
    assert "#" in txt


def test_gantt_compute_and_transfer_lanes_coexist():
    tl = Timeline()
    tl.add(_compute("a", "gpu0", 0.2, 1.0))
    xfer = dict(link="host->gpu0", task="a", nbytes=4096, model_start=0.0,
                model_end=0.2)
    tl.add_transfer(TransferEvent(**xfer))
    txt = tl.gantt(48)
    assert txt == _jax_gantt([("a", "gpu0", 0.2, 1.0)], [xfer], 48)
    lines = txt.splitlines()
    assert any(ln.lstrip().startswith("gpu0") and "#" in ln for ln in lines)
    assert any("host->gpu0" in ln and "=" in ln for ln in lines)
    assert "(modeled)" in lines[-1]
