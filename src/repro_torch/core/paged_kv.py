"""Paged KV-cache pool — the production arena instance of RIMMS.

This is the load-bearing mapping of the paper's allocator + ``fragment``
machinery onto an LM serving system (DESIGN.md §2, row "hete_Malloc
arena"):

* The device holds one dense KV *page pool* per layer (analogous to the
  ZCU102's physically-contiguous 64 MiB UDMA buffer: jittable code needs
  static shapes, so all KV lives in one preallocated region).
* A host-side **marking system** (bitset or next-fit from
  :mod:`repro.core.allocator`, block = one page) hands out page extents.
* A sequence's KV buffer is *one* extent search fragmented into pages
  (§3.2.3): one ``alloc`` + O(n) fragment instead of n allocs.  When the
  pool is too fragmented for a contiguous run, we degrade to per-page
  allocation (next-fit's rolling cursor makes that amortized O(1)).
* Block tables (page id per logical page of each sequence) are the
  "resource pointers"; they are device inputs to the paged-attention
  kernel.

The pool *arrays* are device tensors that the serving step updates in
place (:func:`write_token`); this class owns only host metadata — exactly
the paper's split (marking metadata on host, payload in resource
memory).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .allocator import AllocError, Extent, make_allocator
from .qos import QuotaExceeded

__all__ = [
    "PagedKVPool",
    "SCRATCH_SEQ",
    "init_pool_arrays",
    "token_slots",
    "write_token",
    "gather_kv",
]

#: reserved sequence id for the sacrificial scratch page: inactive batch
#: slots and block-table padding point at it so full-batch scatter/gather
#: kernels never touch live pages.
SCRATCH_SEQ = -1


@dataclasses.dataclass
class _SeqInfo:
    extents: List[Extent]
    page_ids: List[int]
    n_tokens: int = 0
    tenant: Optional[str] = None


class PagedKVPool:
    """Host-side page bookkeeping for a device KV pool.

    With ``scratch=True`` the pool reserves one sacrificial page at
    construction under :data:`SCRATCH_SEQ`; it is pinned for the pool's
    lifetime (``free_sequence(SCRATCH_SEQ)`` raises) and is charged to no
    tenant.  Per-tenant page quotas (``set_quota``) turn over-budget
    allocations into :class:`~repro.core.qos.QuotaExceeded` instead of
    silently eating the shared pool.
    """

    def __init__(
        self,
        *,
        num_pages: int,
        page_size: int,
        allocator: str = "bitset",
        scratch: bool = False,
    ) -> None:
        self.num_pages = num_pages
        self.page_size = page_size
        # Arena in units of pages: block_size=1 page.
        self.arena = make_allocator(allocator, capacity=num_pages, block_size=1)
        self._seqs: Dict[int, _SeqInfo] = {}
        self._quotas: Dict[str, int] = {}
        self._tenant_pages: Dict[str, int] = {}
        self.fragment_allocs = 0  # single-search contiguous grabs
        self.fallback_allocs = 0  # per-page fallbacks under fragmentation
        self.scratch_page: Optional[int] = None
        if scratch:
            table = self.alloc_sequence(SCRATCH_SEQ, 1)
            self.scratch_page = int(table[0])

    # -- tenant quotas ------------------------------------------------------
    def set_quota(self, tenant: str, max_pages: Optional[int]) -> None:
        """Cap ``tenant`` at ``max_pages`` live pages (None clears)."""
        if max_pages is None:
            self._quotas.pop(tenant, None)
        else:
            self._quotas[tenant] = int(max_pages)

    def tenant_pages(self, tenant: str) -> int:
        """Pages currently held by ``tenant`` (scratch never counts)."""
        return self._tenant_pages.get(tenant, 0)

    def _charge(self, tenant: Optional[str], n_pages: int) -> None:
        if tenant is None:
            return
        quota = self._quotas.get(tenant)
        held = self._tenant_pages.get(tenant, 0)
        if quota is not None and held + n_pages > quota:
            raise QuotaExceeded(
                f"tenant {tenant!r} KV quota exceeded: holds {held} pages, "
                f"wants {n_pages} more, quota {quota}",
                tenant=tenant, location="kv_pool",
            )
        self._tenant_pages[tenant] = held + n_pages

    # -- allocation ---------------------------------------------------------
    def alloc_sequence(
        self, seq_id: int, n_tokens: int, *, tenant: Optional[str] = None
    ) -> np.ndarray:
        """Reserve pages for ``n_tokens`` tokens; returns int32 page ids."""
        if seq_id in self._seqs:
            raise KeyError(f"sequence {seq_id} already allocated")
        n_pages = max(1, -(-n_tokens // self.page_size))
        self._charge(tenant, n_pages)  # quota check before touching arena
        try:
            extents, page_ids = self._grab(n_pages)
        except AllocError:
            if tenant is not None:
                self._tenant_pages[tenant] -= n_pages
            raise
        self._seqs[seq_id] = _SeqInfo(extents, page_ids, n_tokens, tenant)
        return np.asarray(page_ids, dtype=np.int32)

    def extend_sequence(self, seq_id: int, n_new_tokens: int) -> np.ndarray:
        """Grow a sequence (decode appends); returns the full page table."""
        info = self._seqs[seq_id]
        need = -(-(info.n_tokens + n_new_tokens) // self.page_size)
        if need > len(info.page_ids):
            grow = need - len(info.page_ids)
            self._charge(info.tenant, grow)
            try:
                extents, page_ids = self._grab(grow)
            except AllocError:
                if info.tenant is not None:
                    self._tenant_pages[info.tenant] -= grow
                raise
            info.extents.extend(extents)
            info.page_ids.extend(page_ids)
        info.n_tokens += n_new_tokens
        return np.asarray(info.page_ids, dtype=np.int32)

    def _grab(self, n_pages: int) -> Tuple[List[Extent], List[int]]:
        # Fast path: one extent, fragmented into pages (the paper's
        # fragment(): one search for n buffers).
        try:
            ext = self.arena.alloc(n_pages)
            self.fragment_allocs += 1
            return [ext], list(range(ext.offset, ext.offset + n_pages))
        except AllocError:
            pass
        # Fragmented pool: fall back to page-at-a-time.
        extents: List[Extent] = []
        try:
            for _ in range(n_pages):
                extents.append(self.arena.alloc(1))
        except AllocError:
            for e in extents:
                self.arena.free(e)
            raise AllocError(
                f"KV pool exhausted: need {n_pages} pages, "
                f"{self.free_pages} free"
            )
        self.fallback_allocs += 1
        return extents, [e.offset for e in extents]

    def free_sequence(self, seq_id: int) -> None:
        if seq_id == SCRATCH_SEQ and self.scratch_page is not None:
            raise ValueError(
                "scratch page is pool-owned and pinned; it cannot be freed"
            )
        info = self._seqs.pop(seq_id, None)
        if info is None:
            raise KeyError(
                f"sequence {seq_id} is not allocated (double free?)"
            )
        if info.tenant is not None:
            self._tenant_pages[info.tenant] -= len(info.page_ids)
        for ext in info.extents:
            self.arena.free(ext)

    # -- introspection --------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return self.arena.free_bytes  # capacity is in page units

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.free_pages

    def n_tokens(self, seq_id: int) -> int:
        return self._seqs[seq_id].n_tokens

    def page_table(self, seq_id: int, pad_to: Optional[int] = None) -> np.ndarray:
        ids = list(self._seqs[seq_id].page_ids)
        if pad_to is not None:
            ids = ids + [0] * (pad_to - len(ids))
        return np.asarray(ids, dtype=np.int32)


# ---------------------------------------------------------------------------
# Device-side helpers (torch; used by the serve engine and the tests)
# ---------------------------------------------------------------------------


def init_pool_arrays(num_pages, page_size, kv_heads, head_dim, dtype,
                     device=None):
    """(k_pool, v_pool) with shape (num_pages, page_size, kv_heads,
    head_dim), zero-filled: inactive batch rows read the scratch page, and
    uninitialised memory there could turn their discarded outputs into
    NaN."""
    shape = (num_pages, page_size, kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def token_slots(block_table, pos, page_size: int):
    """(page id, slot in the page) of each sequence's token at ``pos`` —
    the scatter indices of :func:`write_token`, the same for every layer
    of a decode step."""
    pos = pos.long()
    logical_page = torch.div(pos, page_size, rounding_mode="floor")
    page_id = block_table.long().gather(1, logical_page[:, None])[:, 0]
    return page_id, pos % page_size


def write_token(pool, block_table, pos, new, *, slots=None):
    """Scatter one token per sequence into the pool, **in place** (the
    reference returns a new array; the values are the same), and return
    the pool.

    pool:        (num_pages, page_size, kv_heads, head_dim)
    block_table: (batch, max_pages) int32 — page id per logical page
    pos:         (batch,) int32 — token position being written
    new:         (batch, kv_heads, head_dim)
    slots:       :func:`token_slots` of the above, when made already
    """
    if slots is None:
        slots = token_slots(block_table, pos, pool.shape[1])
    pool.index_put_(slots, new.to(pool.dtype))
    return pool


def gather_kv(pool, block_table, max_len):
    """Gather a dense (batch, max_len, kv_heads, head_dim) view of the pool
    (reference path / tests; the CUDA kernel reads pages in place)."""
    page_size = pool.shape[1]
    n_pages = max_len // page_size
    pages = pool[block_table[:, :n_pages].long()]  # (B, n_pages, page, H, D)
    b = pages.shape[0]
    return pages.reshape(b, n_pages * page_size, *pool.shape[2:])
