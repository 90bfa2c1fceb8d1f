"""Paged decode attention over RIMMS block tables (the serving hot spot).

Two versions of one function over q (B, Hq, d), the K/V page pools
(P, page, Hkv, d), ``block_table`` (B, n_pages) int32 and ``lengths``
(B,) int32, float32 or bfloat16, accumulating in float32:

* :func:`paged_attention_kernel` launches the hand-written CUDA kernel
  (``csrc/paged_attention.cu``): one thread block per (KV head,
  sequence, split of the table's pages) reads the pages in place through
  the block table and writes float32 partials (m, l, acc) to a
  workspace, and the last block of each (sequence, KV head) to finish
  merges its splits in split order: one kernel a call, nothing else on
  the device.  :func:`split_plan` fixes the splits from the table width
  and the page size alone;
* :func:`paged_attention_plain` is the reference oracle's dense gather
  (:mod:`.ref`) — what a CPU tensor runs, and what the kernel is held
  against on the card.

Both mask positions at or past ``lengths[b]`` with ``-1e30``, so a row
of length 0 gets the uniform mean of V over its table's positions.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from .._build import check, launch, library, raw_stream
from .ref import paged_attention as paged_attention_plain

__all__ = ["MAX_HEAD_DIM", "MAX_GROUP_ELEMS", "MAX_SPLITS", "SPLIT_POSITIONS",
           "split_plan", "paged_attention_kernel", "paged_attention_plain",
           "launches"]

#: widest head the kernel takes
MAX_HEAD_DIM = 256
#: most accumulator elements a block carries: (Hq / Hkv) * d
MAX_GROUP_ELEMS = 4096
#: most splits of one sequence's table
MAX_SPLITS = 16
#: fewest positions a split holds (one chunk of the kernel), where the
#: table is that long
SPLIT_POSITIONS = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the count was last set to 0 (one per call)
launches = 0
_count_lock = threading.Lock()
#: (device index, stream) -> (float32 workspace, int32 arrival counters
#: zeroed once).  Calls on one stream run one after another on the card
#: and the kernel leaves the counters 0, so they share both; calls on two
#: streams, which may overlap, never do
_scratch = {}


def split_plan(n_pages: int, page: int):
    """(pages per split, number of splits) for a table of ``n_pages``
    pages of ``page`` positions: whole pages, at most :data:`MAX_SPLITS`
    splits, each at least :data:`SPLIT_POSITIONS` positions long where
    the table allows.  A function of ``n_pages`` and ``page`` alone, so a
    row's split layout (and so its result) never depends on the batch,
    the pool, the dtype or another row's length.  Split ``s`` covers
    positions ``[s * pps * page, min((s + 1) * pps * page, n_pages *
    page))``; the splits cover the table once."""
    pps = max(-(-n_pages // MAX_SPLITS), -(-SPLIT_POSITIONS // page), 1)
    return pps, max(-(-n_pages // pps), 1)


def paged_attention_kernel(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Same shapes as :func:`paged_attention_plain`; contiguous, on one
    CUDA device, q and the pages of one dtype, the table and lengths
    int32.  The caller has validated them; this launches one kernel on
    the current stream and does not wait.  Returns a fresh (B, Hq, d)
    tensor."""
    global launches
    batch, hq, d = q.shape
    n_pages_pool, page, hkv, _ = k_pages.shape
    n_pages = block_table.shape[1]
    out = torch.empty_like(q)
    if batch == 0:
        return out
    pps, n_splits = split_plan(n_pages, page)
    # each split's partials (acc, m, l), and per (sequence, KV head) a
    # count of the splits done, from which the last one knows it is last
    # (and sets the count back to 0)
    n_ws = batch * hkv * n_splits * (hq // hkv) * (d + 2)
    key = (q.get_device(), raw_stream(q))
    with _count_lock:
        workspace, counters = _scratch.get(key, (None, None))
        if workspace is None or workspace.numel() < n_ws:
            workspace = torch.empty(n_ws, dtype=torch.float32,
                                    device=q.device)
        if counters is None or counters.numel() < batch * hkv:
            counters = torch.zeros(batch * hkv, dtype=torch.int32,
                                   device=q.device)
        _scratch[key] = workspace, counters
    check(launch(library().rimms_paged_attention, q, q.data_ptr(),
                 k_pages.data_ptr(), v_pages.data_ptr(),
                 block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 workspace.data_ptr(), counters.data_ptr(), batch, hq, hkv,
                 d, n_pages_pool, page, n_pages, pps, n_splits,
                 _DTYPE_CODE[q.dtype], ctypes.c_float(math.sqrt(d))),
          "paged_attention")
    with _count_lock:
        launches += 1
    return out
