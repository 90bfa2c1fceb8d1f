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

The backward is the same chunked scan run from the last step back
(``csrc/rg_lru_bwd.cu`` and :func:`rg_lru_backward_plain`, equal bit
for bit): with g_t the gradient reaching h_t, g_t = dh_t + a_{t+1} g_{t+1}
from g_S = dh_S + dh_final, then da_t = g_t h_{t-1}, db_t = g_t and
dh0 = a_1 g_1, reading the forward's own h_seq.
"""

from __future__ import annotations

import threading

import torch

from .._build import check, launch, library

__all__ = ["CHUNK", "LANES", "launch_plan", "rg_lru_kernel", "rg_lru_plain",
           "rg_lru_backward_kernel", "rg_lru_backward_plain", "launches",
           "backward_launches"]

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
#: backward kernel launches since the count was last set to 0
backward_launches = 0
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


def rg_lru_backward_kernel(a: torch.Tensor, hs: torch.Tensor,
                           h0: torch.Tensor, dhs: torch.Tensor,
                           dhn: torch.Tensor, *, block_lanes: int = LANES):
    """The gradients (da, db, dh0) of ``rg_lru_kernel``'s (h_seq, h_final)
    given theirs (dhs, dhn), from its inputs a, h0 and its output hs: all
    contiguous float32 on one CUDA device, shaped as the forward's.  The
    caller has validated them; this launches on the current stream and
    does not wait."""
    global backward_launches
    batch, s, d = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    if batch == 0 or d == 0:
        return da, db, dh0
    sums = torch.empty(launch_plan(batch, s, d, block_lanes)["sums_shape"],
                       dtype=torch.float32, device=a.device)
    check(launch(library().rimms_rg_lru_bwd_f32, a, a.data_ptr(),
                 hs.data_ptr(), h0.data_ptr(), dhs.data_ptr(),
                 dhn.data_ptr(), da.data_ptr(), db.data_ptr(),
                 dh0.data_ptr(), sums.data_ptr(), batch, s, d,
                 int(block_lanes), CHUNK), "rg_lru backward")
    with _count_lock:
        backward_launches += 1
    return da, db, dh0


def rg_lru_backward_plain(a: torch.Tensor, hs: torch.Tensor,
                          h0: torch.Tensor, dhs: torch.Tensor,
                          dhn: torch.Tensor):
    """The backward kernel's chunked reverse scan in torch ops: with E
    the gradient a step hands the step before it (a_t g_t), each chunk
    from E = 0 at its end gives its local E and its product of a's, the
    carry runs from E = dh_final at the last chunk back, and every chunk
    is rescanned from its carry, g = dh + E, da = g h_prev, db = g,
    E = a g.  Returns (da, db, dh0) in fresh tensors."""
    batch, s, d = a.shape
    n = max(-(-s // CHUNK), 1)
    pad = n * CHUNK - s
    # steps past S are identities (a = 1, dh = 0) and are dropped
    ac = torch.cat([a, a.new_ones((batch, pad, d))], 1).view(
        batch, n, CHUNK, d)
    gc = torch.cat([dhs, dhs.new_zeros((batch, pad, d))], 1).view(
        batch, n, CHUNK, d)
    hp = torch.cat([h0[:, None], hs], 1)[:, :s]  # h_{t-1}
    hp = torch.cat([hp, hs.new_zeros((batch, pad, d))], 1).view(
        batch, n, CHUNK, d)
    # 1. every chunk from E = 0 at its end: its local E and product of a's
    e = torch.zeros((batch, n, d), dtype=a.dtype, device=a.device)
    p = torch.ones_like(e)
    for t in reversed(range(CHUNK)):
        e = ac[:, :, t] * (gc[:, :, t] + e)
        p = p * ac[:, :, t]
    # 2. the carry entering each chunk at its end, in reverse chunk order
    ein = torch.empty_like(e)
    state = dhn.clone()
    for k in reversed(range(n)):
        ein[:, k] = state
        state = p[:, k] * state + e[:, k]
    # 3. every chunk rescanned from its carry
    da, db = torch.empty_like(ac), torch.empty_like(ac)
    e = ein
    for t in reversed(range(CHUNK)):
        g = gc[:, :, t] + e
        db[:, :, t] = g
        da[:, :, t] = g * hp[:, :, t]
        e = ac[:, :, t] * g
    da = da.view(batch, n * CHUNK, d)[:, :s].contiguous()
    db = db.view(batch, n * CHUNK, d)[:, :s].contiguous()
    return da, db, e[:, 0].clone()
