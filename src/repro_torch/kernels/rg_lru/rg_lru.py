"""RG-LRU linear recurrence (the RecurrentGemma prefill hot spot).

h_t = a_t · h_{t-1} + b_t, elementwise over (B, S, D) float32.  Two
versions of one function, both a chunked scan over S in chunks of
:data:`CHUNK` steps (the last one may be shorter):

* :func:`rg_lru_kernel` launches the hand-written CUDA kernel
  (``csrc/rg_lru.cu``): one pass scans every chunk but the last from
  h = 0 into a summary (the product P of its a's, its local state h),
  a second carries h0 across the summaries before each chunk and runs
  the recurrence over the chunk from there;
* :func:`rg_lru_plain` is the same arithmetic in torch ops, every chunk
  at once — what a CPU tensor runs, and what the kernel is held against
  on the card.

Both compute every product and sum rounded on its own, in the same
order, so they agree bit for bit.  A sequence of at most CHUNK steps is
one chunk, and then both are the sequential loop.
"""

from __future__ import annotations

import threading

import torch

from .._build import check, launch, library

__all__ = ["CHUNK", "LANES", "launch_plan", "rg_lru_kernel", "rg_lru_plain",
           "launches"]

#: lane granularity of ``block_lanes`` (the reference's vector width;
#: the wrapper clamps ``block_lanes`` to a multiple of it)
LANES = 128
#: steps per chunk of the scan; the same for every S, card and
#: ``block_lanes``, so the bits depend on the inputs alone
CHUNK = 64

#: the kernel's largest block (``csrc/rg_lru.cu`` kMaxThreads)
MAX_THREADS = 512

#: kernel launches since the count was last set to 0
launches = 0
_count_lock = threading.Lock()


def launch_plan(batch: int, s: int, d: int, block_lanes: int) -> dict:
    """The kernel's geometry for one call: chunks of S, the grid of each
    pass (lane tiles, chunks, batch; the summary pass skips the last
    chunk), threads a block and the summaries' workspace shape."""
    chunks = max(-(-s // CHUNK), 1)
    tiles = -(-d // block_lanes)
    return {"chunks": chunks,
            "summary_grid": (tiles, chunks - 1, batch),
            "scan_grid": (tiles, chunks, batch),
            "threads": min(block_lanes, MAX_THREADS),
            "sums_shape": (batch, chunks - 1, d, 2)}


def rg_lru_kernel(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
                  block_lanes: int = LANES):
    """a, b: (B, S, D), h0: (B, D), contiguous float32 on one CUDA device
    → (h_seq (B, S, D), h_final (B, D)) in fresh tensors.  The caller has
    validated them; this launches on the current stream and does not
    wait."""
    global launches
    batch, s, d = a.shape
    hs = torch.empty_like(a)
    hn = torch.empty_like(h0)
    if batch == 0 or d == 0:
        return hs, hn
    sums = torch.empty(launch_plan(batch, s, d, block_lanes)["sums_shape"],
                       dtype=torch.float32, device=a.device)
    check(launch(library().rimms_rg_lru_f32, a, a.data_ptr(), b.data_ptr(),
                 h0.data_ptr(), hs.data_ptr(), hn.data_ptr(),
                 sums.data_ptr(), batch, s, d, int(block_lanes), CHUNK),
          "rg_lru")
    with _count_lock:
        launches += 1
    return hs, hn


def rg_lru_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """The kernel's chunked scan in torch ops, a multiply then an add per
    step.  Returns (h_seq, h_final) in fresh tensors."""
    batch, s, d = a.shape
    n = max(-(-s // CHUNK), 1)
    pad = n * CHUNK - s
    # steps past S are identities (a = 1, b = 0) and are dropped
    ac = torch.cat([a, a.new_ones((batch, pad, d))], 1).view(
        batch, n, CHUNK, d)
    bc = torch.cat([b, b.new_zeros((batch, pad, d))], 1).view(
        batch, n, CHUNK, d)
    # 1. every chunk from h = 0: its product of a's and its local state
    h = torch.zeros((batch, n, d), dtype=a.dtype, device=a.device)
    p = torch.ones_like(h)
    for t in range(CHUNK):
        h = ac[:, :, t] * h + bc[:, :, t]
        p = p * ac[:, :, t]
    # 2. each chunk's incoming state, carried in chunk order
    hin = torch.empty_like(h)
    state = h0.clone()
    for k in range(n):
        hin[:, k] = state
        state = p[:, k] * state + h[:, k]
    # 3. the recurrence over every chunk from its incoming state
    hs = torch.empty_like(ac)
    h = hin
    for t in range(CHUNK):
        h = ac[:, :, t] * h + bc[:, :, t]
        hs[:, :, t] = h
    hs = hs.view(batch, n * CHUNK, d)[:, :s].contiguous()
    return hs, (hs[:, -1].clone() if s else h0.clone())
