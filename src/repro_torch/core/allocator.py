"""Arena allocators — the paper's two "marking systems" (RIMMS §3.2.2).

Two interchangeable heap managers over a byte-addressed resource arena:

* :class:`BitsetAllocator` — the paper's lightweight bitset-based marking
  system.  The arena is divided into fixed-size blocks; one bit per block
  marks it used.  Allocation is an exhaustive first-fit search for a
  contiguous run of free blocks.  Metadata footprint: 1 bit / block.

* :class:`NextFitAllocator` — the paper's NF-based marking system.  A
  circular doubly-linked list of segments with a rolling search pointer;
  allocation splits the first fitting free segment, deallocation coalesces
  with free neighbours.  Metadata footprint ≈ 17 bytes / entry (paper's
  figure; we model the same per-entry cost in :meth:`metadata_bytes`).
  No fixed block-size constraint → arbitrary-size allocations.

Both are host-side metadata structures (exactly as in the paper, where the
marking systems run on the host CPU and manage accelerator memory): they
never touch the payload bytes, they only hand out ``(offset, size)``
extents inside a resource memory region (a UDMA buffer on the ZCU102; a
region of a CUDA device's memory in this PyTorch port).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "AllocError",
    "Extent",
    "BitsetAllocator",
    "NextFitAllocator",
    "make_allocator",
]


class AllocError(Exception):
    """Raised when an allocation cannot be satisfied.

    The paper terminates the runtime in this case (§3.2.2: "If there is
    not enough space for allocation, the runtime system is terminated").
    We surface the condition as an exception so the embedding runtime can
    choose to terminate, evict, or spill.
    """


@dataclasses.dataclass(frozen=True)
class Extent:
    """An allocated extent inside an arena: ``[offset, offset + size)``."""

    offset: int
    size: int

    @property
    def end(self) -> int:
        return self.offset + self.size


class _AllocatorBase:
    """Shared bookkeeping: capacity, counters for benchmarks.

    Eviction support: ``alloc`` accepts an optional opaque
    ``tag`` (the owning buffer identity, set by the eviction engine in
    :mod:`repro_torch.core.hete`); :meth:`tags` exposes the live
    ``offset → tag`` map so pressure diagnostics can attribute every
    resident extent.  ``n_coalesces`` counts free-list merges and
    :meth:`largest_free` reports the biggest contiguous hole — together
    they tell whether an :class:`AllocError` under pressure means "full"
    or "fragmented".
    """

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.used_bytes = 0
        # Instrumentation for the paper's Fig 7 / Fig 10 benchmarks.
        self.n_allocs = 0
        self.n_frees = 0
        self.n_steps = 0  # search steps taken (comparisons / node visits)
        self.n_coalesces = 0  # free-list merges performed on free()
        self._tags: dict = {}  # offset -> opaque per-extent metadata

    # --- interface -----------------------------------------------------
    def alloc(self, nbytes: int, tag=None) -> Extent:  # pragma: no cover
        raise NotImplementedError

    def free(self, extent: Extent) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def metadata_bytes(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def largest_free(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def free_bytes(self) -> int:
        return self.capacity - self.used_bytes

    def tags(self) -> dict:
        """Live ``offset → tag`` map for resident extents."""
        return dict(self._tags)

    def frag_stats(self) -> dict:
        """Fragmentation evidence for pressure diagnostics."""
        largest = self.largest_free()
        return {
            "free_bytes": self.free_bytes,
            "largest_free": largest,
            "frag_ratio": 0.0 if not self.free_bytes
            else 1.0 - largest / self.free_bytes,
            "n_coalesces": self.n_coalesces,
        }

    def reset_counters(self) -> None:
        self.n_allocs = self.n_frees = self.n_steps = self.n_coalesces = 0


class BitsetAllocator(_AllocatorBase):
    """Bitset marking system: 1 bit per fixed-size block, first-fit runs.

    The bitmap is held in a single Python int (bit ``i`` set ⇔ block ``i``
    used), so the contiguous-run search is a handful of big-int AND/shift
    operations (a word-parallel version of the paper's exhaustive scan)
    while remaining semantically a first-fit over all blocks.
    """

    def __init__(self, capacity: int, block_size: int) -> None:
        super().__init__(capacity)
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = int(block_size)
        self.n_blocks = (self.capacity + self.block_size - 1) // self.block_size
        self._bits = 0  # bit i set == block i in use
        self._full_mask = (1 << self.n_blocks) - 1

    # -- helpers --------------------------------------------------------
    def _find_run(self, k: int) -> int:
        """Lowest block index starting a run of ``k`` free blocks, or -1.

        Uses shift-doubling: ``g`` keeps, at bit ``i``, whether blocks
        ``i .. i+s-1`` are all free; doubling ``s`` reaches ``k`` in
        O(log k) big-int ops.
        """
        g = ~self._bits & self._full_mask
        s = 1
        while s < k and g:
            step = min(s, k - s)
            g &= g >> step
            s += step
            self.n_steps += 1
        if g == 0:
            return -1
        return (g & -g).bit_length() - 1

    # -- interface -------------------------------------------------------
    def alloc(self, nbytes: int, tag=None) -> Extent:
        if nbytes <= 0:
            raise ValueError(f"alloc size must be positive, got {nbytes}")
        k = (nbytes + self.block_size - 1) // self.block_size
        idx = self._find_run(k)
        if idx < 0 or idx + k > self.n_blocks:
            raise AllocError(
                f"bitset arena exhausted: need {k} contiguous blocks "
                f"({nbytes} B), capacity {self.n_blocks} blocks"
            )
        run_mask = ((1 << k) - 1) << idx
        self._bits |= run_mask
        self.n_allocs += 1
        size = k * self.block_size
        self.used_bytes += size
        if tag is not None:
            self._tags[idx * self.block_size] = tag
        return Extent(idx * self.block_size, size)

    def free(self, extent: Extent) -> None:
        if extent.offset % self.block_size or extent.size % self.block_size:
            raise ValueError(f"extent {extent} not block-aligned")
        idx = extent.offset // self.block_size
        k = extent.size // self.block_size
        run_mask = ((1 << k) - 1) << idx
        if self._bits & run_mask != run_mask:
            raise AllocError(f"double free / corrupt extent: {extent}")
        self._bits &= ~run_mask
        self.n_frees += 1
        self.used_bytes -= extent.size
        self._tags.pop(extent.offset, None)

    def metadata_bytes(self) -> int:
        return (self.n_blocks + 7) // 8  # 1 bit per block

    def largest_free(self) -> int:
        """Largest contiguous free run in bytes (shift-doubling probe)."""
        g = ~self._bits & self._full_mask
        if g == 0:
            return 0
        # Binary-search the largest k with a surviving run: double until
        # extinction, then the last surviving mask's run length is exact
        # enough for diagnostics (lower bound within 2×); refine linearly.
        k = 1
        cur = g
        while True:
            nxt = cur & (cur >> k)
            if nxt == 0:
                break
            cur = nxt
            k *= 2
        # cur holds runs of length k; extend one block at a time
        n = k
        while True:
            nxt = cur & (g >> n)
            if nxt == 0:
                break
            cur = nxt
            n += 1
        return n * self.block_size


@dataclasses.dataclass
class _Seg:
    """Next-fit linked-list node. ~17 B of payload metadata in the paper."""

    offset: int
    size: int
    used: bool
    prev: Optional["_Seg"] = dataclasses.field(default=None, repr=False)
    next: Optional["_Seg"] = dataclasses.field(default=None, repr=False)


class NextFitAllocator(_AllocatorBase):
    """NF marking system: rolling pointer, split on alloc, coalesce on free."""

    #: the paper's figure for per-entry metadata footprint.
    BYTES_PER_ENTRY = 17

    def __init__(self, capacity: int) -> None:
        super().__init__(capacity)
        head = _Seg(0, capacity, used=False)
        head.prev = head.next = head  # circular
        self._head = head
        self._cursor = head
        self._n_segs = 1
        # offset -> segment, for O(1) free()
        self._by_offset = {0: head}

    # -- interface -------------------------------------------------------
    def alloc(self, nbytes: int, tag=None) -> Extent:
        if nbytes <= 0:
            raise ValueError(f"alloc size must be positive, got {nbytes}")
        seg = self._cursor
        for _ in range(self._n_segs):
            self.n_steps += 1
            if not seg.used and seg.size >= nbytes:
                ext = self._take(seg, nbytes)
                if tag is not None:
                    self._tags[ext.offset] = tag
                return ext
            seg = seg.next
        raise AllocError(
            f"next-fit arena exhausted: need {nbytes} B, "
            f"free {self.free_bytes} B (largest hole {self.largest_free()} B)"
        )

    def _take(self, seg: _Seg, nbytes: int) -> Extent:
        if seg.size > nbytes:
            # Split: first part sized exactly to the request (paper §3.2.2),
            # remainder stays free and becomes the new rolling cursor.
            rest = _Seg(seg.offset + nbytes, seg.size - nbytes, used=False)
            rest.prev, rest.next = seg, seg.next
            seg.next.prev = rest
            seg.next = rest
            seg.size = nbytes
            self._by_offset[rest.offset] = rest
            self._n_segs += 1
            self._cursor = rest
        else:
            self._cursor = seg.next
        seg.used = True
        self.n_allocs += 1
        self.used_bytes += seg.size
        return Extent(seg.offset, seg.size)

    def free(self, extent: Extent) -> None:
        seg = self._by_offset.get(extent.offset)
        if seg is None or not seg.used or seg.size != extent.size:
            raise AllocError(f"double free / corrupt extent: {extent}")
        seg.used = False
        self.n_frees += 1
        self.used_bytes -= seg.size
        self._tags.pop(extent.offset, None)
        # Coalesce with next, then prev (watching the circular wrap).
        nxt = seg.next
        if nxt is not seg and not nxt.used and nxt.offset == seg.offset + seg.size:
            self._absorb(seg, nxt)
        prv = seg.prev
        if prv is not seg and not prv.used and seg.offset == prv.offset + prv.size:
            self._absorb(prv, seg)

    def _absorb(self, left: _Seg, right: _Seg) -> None:
        """Merge ``right`` into ``left`` (both free, adjacent)."""
        if self._cursor is right:
            self._cursor = left
        left.size += right.size
        left.next = right.next
        right.next.prev = left
        del self._by_offset[right.offset]
        self._n_segs -= 1
        self.n_coalesces += 1

    def metadata_bytes(self) -> int:
        return self._n_segs * self.BYTES_PER_ENTRY

    def largest_free(self) -> int:
        """Largest free segment in bytes (free list is always coalesced)."""
        largest = 0
        seg = self._head
        for _ in range(self._n_segs):
            if not seg.used and seg.size > largest:
                largest = seg.size
            seg = seg.next
        return largest

    # -- introspection (tests / benchmarks) ------------------------------
    def segments(self) -> list[tuple[int, int, bool]]:
        out = []
        seg = self._head
        for _ in range(self._n_segs):
            out.append((seg.offset, seg.size, seg.used))
            seg = seg.next
        return sorted(out)


def make_allocator(kind: str, capacity: int, block_size: int = 4096):
    """Factory. ``kind`` ∈ {"bitset", "nextfit"}."""
    if kind == "bitset":
        return BitsetAllocator(capacity, block_size)
    if kind == "nextfit":
        return NextFitAllocator(capacity)
    raise ValueError(f"unknown allocator kind {kind!r}")
