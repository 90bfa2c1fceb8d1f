"""The port's allocators against the reference (``tests/test_allocators.py``).

Every case of the reference's allocator tests runs here on
``repro_torch.core.allocator``.  Where a value is computed, the JAX
package's allocator computes it too from the same request sequence and
the two must be equal: every extent's offset and size, the used and free
byte counts, the next-fit segment list and the arena search steps.  The
property test uses ``hypothesis`` when it is installed, as the
reference's does; the deterministic fallback covers the same invariants.
"""

import random

import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

from repro.core import allocator as jalloc
from repro_torch.core.allocator import (
    AllocError, BitsetAllocator, NextFitAllocator, make_allocator,
)

torch.set_num_threads(1)


def _state(a):
    """What an allocator exposes after a sequence: counters, and the
    segment list (next-fit) or the bitmap (bitset)."""
    segs = a.segments() if hasattr(a, "segments") else a._bits
    return (a.used_bytes, a.free_bytes, a.n_allocs, a.n_steps, segs)


@pytest.mark.parametrize("kind", ["bitset", "nextfit"])
def test_basic_alloc_free(kind):
    a = make_allocator(kind, 1 << 16, 256)
    e1 = a.alloc(1000)
    e2 = a.alloc(500)
    assert e1.end <= e2.offset or e2.end <= e1.offset
    j = jalloc.make_allocator(kind, 1 << 16, 256)
    assert [(e.offset, e.size) for e in (e1, e2)] == [
        (e.offset, e.size) for e in (j.alloc(1000), j.alloc(500))]
    a.free(e1)
    a.free(e2)
    assert a.used_bytes == 0


@pytest.mark.parametrize("kind", ["bitset", "nextfit"])
def test_double_free_raises(kind):
    a = make_allocator(kind, 1 << 12, 64)
    e = a.alloc(64)
    a.free(e)
    with pytest.raises(AllocError):
        a.free(e)


def test_bitset_block_rounding():
    a = BitsetAllocator(4096, 256)
    e = a.alloc(1)  # rounds to one block
    assert e.size == 256
    assert a.metadata_bytes() == 2  # 16 blocks -> 2 bytes
    assert a.metadata_bytes() == jalloc.BitsetAllocator(4096, 256).metadata_bytes()


def test_bitset_exhaustion():
    a = BitsetAllocator(1024, 256)
    a.alloc(1024)
    with pytest.raises(AllocError):
        a.alloc(1)


def test_nextfit_split_and_coalesce():
    a = NextFitAllocator(1000)
    e1, e2, e3 = a.alloc(100), a.alloc(200), a.alloc(300)
    a.free(e2)
    a.free(e1)  # must coalesce with e2's hole
    segs = a.segments()
    assert (0, 300, False) in segs
    j = jalloc.NextFitAllocator(1000)
    j1, j2, _ = j.alloc(100), j.alloc(200), j.alloc(300)
    j.free(j2)
    j.free(j1)
    assert segs == j.segments()
    a.free(e3)
    assert a.segments() == [(0, 1000, False)]


def test_nextfit_exact_size_split():
    a = NextFitAllocator(1000)
    e = a.alloc(123)
    assert e.size == 123  # paper: first segment sized precisely


def test_nextfit_rolling_cursor_is_fast():
    """Next-fit should not rescan from the start each time (paper: 2.55×
    faster than bitset) — allocation steps stay O(1) amortized."""
    a = NextFitAllocator(1 << 20)
    a.reset_counters()
    for _ in range(1000):
        a.alloc(64)
    assert a.n_steps <= 2 * a.n_allocs
    j = jalloc.NextFitAllocator(1 << 20)
    j.reset_counters()
    for _ in range(1000):
        j.alloc(64)
    assert (a.n_steps, a.n_allocs) == (j.n_steps, j.n_allocs)


def test_fragmentation_fallback_behaviour():
    a = NextFitAllocator(1000)
    xs = [a.alloc(100) for _ in range(10)]
    for x in xs[::2]:
        a.free(x)
    # 500 bytes free but fragmented into 100-byte holes
    with pytest.raises(AllocError):
        a.alloc(200)
    assert a.free_bytes == 500


def _check_invariants(kind, ops):
    """Invariants under arbitrary alloc/free sequences: live extents
    never overlap, stay in bounds, used_bytes is conserved, and freeing
    everything restores an empty arena.  The JAX package's allocator
    takes the same requests and must hand out the same extents."""
    cap = 1 << 14
    a = make_allocator(kind, cap, 64)
    j = jalloc.make_allocator(kind, cap, 64)
    live, jlive = [], []
    for is_alloc, size in ops:
        if is_alloc or not live:
            try:
                e = a.alloc(size)
            except AllocError:
                with pytest.raises(jalloc.AllocError):
                    j.alloc(size)
                continue
            je = j.alloc(size)
            assert (e.offset, e.size) == (je.offset, je.size)
            assert 0 <= e.offset and e.end <= cap
            for other in live:
                assert e.end <= other.offset or other.end <= e.offset
            live.append(e)
            jlive.append(je)
        else:
            a.free(live.pop(len(live) // 2))
            j.free(jlive.pop(len(jlive) // 2))
        assert _state(a) == _state(j)
    assert a.used_bytes == sum(e.size for e in live)
    for e in live:
        a.free(e)
    assert a.used_bytes == 0
    if kind == "nextfit":
        assert a.segments() == [(0, cap, False)]
    else:
        assert a._bits == 0


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(
        kind=st.sampled_from(["bitset", "nextfit"]),
        ops=st.lists(
            st.tuples(st.booleans(), st.integers(1, 2000)), min_size=1,
            max_size=120,
        ),
    )
    def test_property_no_overlap_and_conservation(kind, ops):
        _check_invariants(kind, ops)
else:
    def test_property_no_overlap_and_conservation():
        pytest.importorskip("hypothesis")


@pytest.mark.parametrize("kind", ["bitset", "nextfit"])
def test_random_ops_invariants_fallback(kind):
    """Deterministic pseudo-random coverage of the same invariants —
    always runs, so the core assertions hold even without hypothesis."""
    rng = random.Random(0xA110C)
    for _ in range(40):
        ops = [
            (rng.random() < 0.6, rng.randint(1, 2000))
            for _ in range(rng.randint(1, 120))
        ]
        _check_invariants(kind, ops)
