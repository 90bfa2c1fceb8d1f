"""Paged decode attention over RIMMS block tables (the serving hot spot).

Two versions of one function over q (B, Hq, d), the K/V page pools
(P, page, Hkv, d), ``block_table`` (B, n_pages) int32 and ``lengths``
(B,) int32, float32 or bfloat16, accumulating in float32:

* :func:`paged_attention_kernel` launches the hand-written CUDA kernel
  (``csrc/paged_attention.cu``): one thread block per (KV head,
  sequence), the pages read in place through the block table, an online
  softmax over chunks of positions;
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

from .._build import check, library
from .ref import paged_attention as paged_attention_plain

__all__ = ["MAX_HEAD_DIM", "MAX_GROUP_ELEMS", "paged_attention_kernel",
           "paged_attention_plain", "launches"]

#: widest head the kernel takes
MAX_HEAD_DIM = 256
#: most accumulator elements a block carries: (Hq / Hkv) * d
MAX_GROUP_ELEMS = 4096
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the count was last set to 0
launches = 0
_count_lock = threading.Lock()


def paged_attention_kernel(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Same shapes as :func:`paged_attention_plain`; contiguous, on one
    CUDA device, q and the pages of one dtype, the table and lengths
    int32.  The caller has validated them; this launches on the current
    stream and does not wait.  Returns a fresh (B, Hq, d) tensor."""
    global launches
    batch, hq, d = q.shape
    n_pages_pool, page, hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    if batch == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = library().rimms_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            batch, hq, hkv, d, n_pages_pool, page, block_table.shape[1],
            _DTYPE_CODE[q.dtype], ctypes.c_float(math.sqrt(d)), stream)
    check(status, "paged_attention")
    with _count_lock:
        launches += 1
    return out
