"""The port's memory layer against the JAX package's, op for op.

The same malloc / fragment / stage / mark_written / eviction sequence
runs on both packages — the JAX side over ``jax.Array`` device copies,
the port over CPU tensors — and must leave identical extents,
last-resource flags, ledger counters and host values.  Also: the port's
ingest and egress copy (a CPU tensor must never alias a host buffer),
and its entry points refuse to fall back to the CPU unasked.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import hete as jhete
from repro.core.locations import HOST as JHOST
from repro.core.locations import Location as JLocation
from repro_torch.apps import radar as tradar
from repro_torch.core import hete as thete
from repro_torch.core import runtime as truntime
from repro_torch.core.api import Session
from repro_torch.core.locations import HOST as THOST
from repro_torch.core.locations import Location as TLocation

torch.set_num_threads(1)


def _jax_ctx(tracking, capacity):
    ctx = jhete.HeteContext(tracking=tracking)
    for name in ("acc0", "acc1"):
        ctx.register_space(jhete.MemorySpace(
            JLocation("device", name), capacity=capacity, allocator="nextfit",
            block_size=256, ingest=lambda v: jax.device_put(v),
            egress=lambda v: np.asarray(v)))
    return ctx


def _torch_ctx(tracking, capacity):
    ctx = thete.HeteContext(tracking=tracking)
    for name in ("acc0", "acc1"):
        ctx.register_space(thete.MemorySpace(
            TLocation("device", name), capacity=capacity, allocator="nextfit",
            block_size=256, ingest=thete.tensor_ingest("cpu"),
            egress=thete.tensor_egress))
    return ctx


def _sequence(ctx, host, loc):
    """malloc → fill → fragment → stage → device writes → whole-parent
    read → eviction under a small arena.  Returns the observable state."""
    acc0, acc1 = loc("device", "acc0"), loc("device", "acc1")
    rng = np.random.default_rng(7)
    a = ctx.malloc((64,), np.complex64)
    a.data[:] = (rng.normal(size=64) + 1j * rng.normal(size=64))
    b = ctx.malloc((32,), np.complex64)
    b.data[:] = rng.normal(size=32)
    frags = a.fragment(16)
    v0 = ctx.ensure(frags[0], acc0)
    ctx.mark_written(frags[0], acc0, v0 * 2)
    v1 = ctx.ensure(frags[1], acc1)
    ctx.mark_written(frags[1], acc1, v1 + 1)
    whole = ctx.ensure(a, acc0)  # gathers the fragments first
    ctx.mark_written(a, acc0, whole * 3)  # propagates to every fragment
    vb = ctx.ensure(b, acc0)
    ctx.mark_written(b, acc0, vb - 1)
    c = ctx.malloc((48,), np.complex64)  # the arena is full: evicts
    c.data[:] = 5
    ctx.ensure(c, acc0)
    vf = ctx.ensure(frags[2], acc1)
    ctx.mark_written(frags[2], acc1, vf * 0.5)
    ctx.evict(a, acc1)
    host_a = ctx.sync(a).copy()
    host_b = ctx.sync(b).copy()
    state = {
        "extents": {name: sorted((str(l), e.offset, e.size)
                                 for l, e in hd.extents.items())
                    for name, hd in (("a", a), ("b", b), ("c", c))},
        "flags": [str(h.last_location) for h in [a, b, c] + frags],
        "valid_at": [sorted(map(str, h.valid_at)) for h in [a, b, c] + frags],
        "ledger": ctx.ledger.snapshot(),
        "bytes": dict(ctx.ledger.bytes_moved),
        "arena_used": [ctx.spaces[l].arena.used_bytes for l in (acc0, acc1)],
    }
    return state, host_a, host_b


@pytest.mark.parametrize("tracking", ["flag", "cached"])
def test_memory_sequence_matches_jax(tracking):
    js, ja, jb = _sequence(_jax_ctx(tracking, 1024), JHOST, JLocation)
    ts, ta, tb = _sequence(_torch_ctx(tracking, 1024), THOST, TLocation)
    assert ts == js
    assert ts["ledger"]["total_evictions"] >= 1  # pressure really hit
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)


def test_ingest_copies():
    host = np.arange(8, dtype=np.complex64)
    dev = thete.tensor_ingest("cpu")(host)
    host[:] = -1
    assert torch.equal(dev, torch.arange(8).to(torch.complex64))


def test_egress_copies():
    dev = torch.arange(8).to(torch.complex64)
    host = thete.tensor_egress(dev)
    host[:] = -1
    assert torch.equal(dev, torch.arange(8).to(torch.complex64))


def test_staged_device_copy_survives_host_writes():
    """Hazard of zero-copy ingest: the host view a fragment shares with
    its parent is written in place later — the device copy must not
    move with it."""
    ctx = _torch_ctx("flag", 1 << 20)
    acc = TLocation("device", "acc0")
    hd = ctx.malloc((16,), np.complex64)
    hd.data[:] = 1
    hd.fragment(8)
    dev = ctx.ensure(hd[0], acc)
    hd.data[:] = 9  # in-place host write, as the radar builders fill
    assert torch.all(dev == 1)
    ctx.mark_written(hd[0], acc, dev * 2)
    np.testing.assert_array_equal(ctx.sync(hd[0]), np.full(8, 2, np.complex64))


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        truntime.make_emulated_soc()
    with pytest.raises(RuntimeError, match="CUDA"):
        tradar.make_runtime(policy="rimms")
    with pytest.raises(RuntimeError, match="CUDA"):
        Session.emulated()
    pes, ctx = truntime.make_emulated_soc(device="cpu")
    assert [pe.name for pe in pes] == ["cpu0", "fft_acc0", "zip_acc0"]


def test_backends():
    with pytest.raises(NotImplementedError, match="A6"):
        truntime.make_emulated_soc(device="cpu", backend="process")
    with pytest.raises(ValueError, match="unknown backend"):
        truntime.resolve_backend("fibers")
    assert truntime.resolve_backend("auto") == "thread"
    assert truntime.resolve_backend(None) == "thread"
