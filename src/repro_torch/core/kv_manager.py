"""Runtime-managed paged KV cache — the bridge between the serving
stack's page bookkeeping (:mod:`repro_torch.core.paged_kv`) and RIMMS-owned
device memory (:class:`~repro_torch.core.api.Session`).

The legacy :class:`~repro_torch.serve.engine.ServeEngine` holds its KV
pool as two bare device tensors, outside runtime management: no quotas, no pressure
handling, no telemetry.  :class:`KVManager` instead splits the pool into
fixed-size *page groups* and allocates each group's K and V planes as
Session buffers (``hete_Malloc`` under a dedicated owner).  Serving
kernels receive only the groups their block tables actually reference,
remapped into a compact pool, so:

* hot groups stay resident in the device arena (flag-hit staging);
* cold groups become LRU eviction victims under arena pressure — their
  dirty pages write back to host through the *existing* coherence path
  (``ledger.client_writeback_bytes[owner]`` is the spill evidence);
* a later step that references a spilled group re-stages it
  transparently in ``_stage_inputs`` — no serving-specific copy code.

Page bookkeeping (extents, tenant quotas, the sacrificial scratch page)
stays in the tenant-aware :class:`~repro_torch.core.paged_kv.PagedKVPool`;
this class owns only the group geometry and the Session buffers.

bfloat16 groups are held as their 16-bit raw bits (``np.int16``): a
Session buffer's host plane is a numpy array, and numpy has no bfloat16
(and ``Tensor.numpy()`` refuses one).  The serving ops view the group
tensors as ``torch.bfloat16`` and hand them back viewed as ``int16``, so
the ledger's bytes are the same, 2 per element.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .paged_kv import PagedKVPool

__all__ = ["KVManager", "host_dtype"]


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype of a KV group's host plane for compute dtype
    ``dtype`` (a torch dtype or its name): ``int16`` raw bits for
    bfloat16, else the matching numpy type."""
    if dtype in (torch.bfloat16, "bfloat16"):
        return np.dtype(np.int16)
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


class KVManager:
    """Group-granular, Session-owned KV pool.

    ``num_pages`` global pages are split into ``num_pages /
    pages_per_group`` groups; group ``g`` holds pages ``[g * gp, (g + 1)
    * gp)``.  Each group is two Session buffers (K and V) of shape
    ``(n_layers, pages_per_group, page_size, kv_heads, head_dim)`` in
    :func:`host_dtype` of ``dtype``.
    """

    def __init__(
        self,
        session,
        *,
        n_layers: int,
        kv_heads: int,
        head_dim: int,
        num_pages: int,
        page_size: int,
        pages_per_group: int = 8,
        dtype=np.float32,
        allocator: str = "bitset",
        owner: str = "kv-cache",
    ) -> None:
        if num_pages % pages_per_group != 0:
            raise ValueError(
                f"num_pages ({num_pages}) must be a multiple of "
                f"pages_per_group ({pages_per_group})"
            )
        self.session = session
        self.owner = owner
        self.page_size = page_size
        self.pages_per_group = pages_per_group
        self.n_groups = num_pages // pages_per_group
        self.pool = PagedKVPool(
            num_pages=num_pages, page_size=page_size,
            allocator=allocator, scratch=True,
        )
        shape = (n_layers, pages_per_group, page_size, kv_heads, head_dim)
        self.dtype = dtype
        plane = host_dtype(dtype)
        # hete_Malloc zeroes the host planes, matching init_pool_arrays.
        self.k_bufs: List = [
            session.malloc(shape, plane, client=owner)
            for _ in range(self.n_groups)
        ]
        self.v_bufs: List = [
            session.malloc(shape, plane, client=owner)
            for _ in range(self.n_groups)
        ]
        self._scratch_group = self.pool.scratch_page // pages_per_group

    # -- page bookkeeping (delegated to the tenant-aware pool) --------------
    @property
    def scratch_page(self) -> int:
        return self.pool.scratch_page

    def set_quota(self, tenant: str, max_pages: Optional[int]) -> None:
        self.pool.set_quota(tenant, max_pages)

    def alloc(self, seq_id: int, n_tokens: int, *,
              tenant: Optional[str] = None) -> np.ndarray:
        return self.pool.alloc_sequence(seq_id, n_tokens, tenant=tenant)

    def free(self, seq_id: int) -> None:
        self.pool.free_sequence(seq_id)

    @property
    def used_pages(self) -> int:
        return self.pool.used_pages

    # -- group referencing ---------------------------------------------------
    def referenced_groups(self, block_tables: np.ndarray) -> List[int]:
        """Sorted group ids any entry of ``block_tables`` touches.  The
        scratch group is always included: inactive slots and table
        padding point at the scratch page."""
        groups = set(np.unique(block_tables // self.pages_per_group).tolist())
        groups.add(self._scratch_group)
        return sorted(groups)

    def compact_tables(self, block_tables: np.ndarray,
                       groups: Sequence[int]) -> np.ndarray:
        """Remap global page ids to positions in the pool formed by
        concatenating ``groups`` in order (the kernel-side view)."""
        gp = self.pages_per_group
        lut = np.zeros((self.n_groups * gp,), np.int32)
        for i, g in enumerate(groups):
            lut[g * gp:(g + 1) * gp] = np.arange(i * gp, (i + 1) * gp)
        return lut[block_tables].astype(np.int32)

    def buffers(self, groups: Sequence[int]) -> List:
        """K then V Session buffers for ``groups``, the order kernels
        expect their pool inputs/outputs in."""
        return ([self.k_bufs[g] for g in groups]
                + [self.v_bufs[g] for g in groups])

    # -- telemetry -----------------------------------------------------------
    def spill_bytes(self) -> int:
        """Bytes of dirty KV written back to host by arena eviction (the
        runtime coherence path) — 0 while every group fits on device."""
        ledger = self.session.context.ledger
        return int(ledger.client_writeback_bytes.get(self.owner, 0))

    def publish_metrics(self) -> None:
        """Refresh the serving gauges in the session's MetricsRegistry
        (exported by ``metrics_text()``)."""
        m = self.session.metrics
        m.gauge("serve_kv_pages_resident").set(self.used_pages)
        m.gauge("serve_kv_spill_bytes").set(self.spill_bytes())
