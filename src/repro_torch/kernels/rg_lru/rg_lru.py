"""RG-LRU linear recurrence (the RecurrentGemma prefill hot spot).

h_t = a_t · h_{t-1} + b_t, elementwise over (B, S, D) float32.  Two
versions of one function:

* :func:`rg_lru_kernel` launches the hand-written CUDA kernel
  (``csrc/rg_lru.cu``): one thread per (batch, lane) walks the sequence,
  its loads issued a few steps ahead, with the ragged last lane block
  masked rather than padded;
* :func:`rg_lru_plain` is the same sequential loop in torch ops — what
  a CPU tensor runs, and what the kernel is held against on the card.

Both compute each step as a rounded multiply then a rounded add, so
they agree bit for bit.
"""

from __future__ import annotations

import threading

import torch

from .._build import check, launch, library

__all__ = ["LANES", "rg_lru_kernel", "rg_lru_plain", "launches"]

#: lane granularity of ``block_lanes`` (the reference's vector width;
#: the wrapper clamps ``block_lanes`` to a multiple of it)
LANES = 128

#: kernel launches since the count was last set to 0
launches = 0
_count_lock = threading.Lock()


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
    check(launch(library().rimms_rg_lru_f32, a, a.data_ptr(), b.data_ptr(),
                 h0.data_ptr(), hs.data_ptr(), hn.data_ptr(), batch, s, d,
                 int(block_lanes)), "rg_lru")
    with _count_lock:
        launches += 1
    return hs, hn


def rg_lru_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """The kernel's sequential loop in torch ops: a multiply, then an
    add, per step.  Returns (h_seq, h_final) in fresh tensors."""
    hs = torch.empty_like(a)
    h = h0.clone()
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs, h
