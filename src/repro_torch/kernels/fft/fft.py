"""Batched radix-2 Stockham FFT (the paper's FFT accelerator, §4.1).

Two versions of one function, rows of complex64 along the last axis:

* :func:`fft_kernel` launches the hand-written CUDA kernel
  (``csrc/fft.cu``): one thread block per row, the row held in shared
  memory across all log2 N stages, twiddles from ``sincospif``;
* :func:`fft_plain` is the same Stockham recurrence in torch ops
  (slice, butterfly, ``cat``) — what a CPU tensor runs, and what the
  kernel is held against on the card.

Both produce natural order with no bit reversal, and both compute the
inverse directly (twiddle sign flipped, 1/N scale), which equals
``conj(fft(conj x))/N``.  Supports power-of-two N from 2 to 8192.
"""

from __future__ import annotations

import math
import threading

import torch

from .._build import check, library

__all__ = ["BLOCK_ROWS", "MAX_N", "fft_kernel", "fft_plain", "launches"]

#: rows each thread block walks (a pure launch parameter: rows are
#: independent, so every value gives bit-identical output)
BLOCK_ROWS = 8
#: largest N the kernel takes (two float2 rows of N fill 128 KB of
#: shared memory at 8192)
MAX_N = 8192

#: kernel launches since the count was last set to 0
launches = 0
_count_lock = threading.Lock()


def fft_kernel(x: torch.Tensor, *, inverse: bool = False,
               block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """x: (rows, N) contiguous complex64 on a CUDA device → its FFT
    (or inverse FFT), in a fresh tensor.  The caller has validated the
    shape; this launches on the current stream and does not wait."""
    global launches
    rows, n = x.shape
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = library().rimms_fft_c64(
            x.data_ptr(), out.data_ptr(), rows, n, int(inverse),
            int(block_rows), stream)
    check(status, "fft")
    with _count_lock:
        launches += 1
    return out


def fft_plain(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """The Stockham recurrence of :func:`fft_kernel` in torch ops.
    x: (rows, N) complex64 → a fresh (rows, N) complex64 tensor."""
    rows, n = x.shape
    y = x.reshape(rows, 1, n)
    sign = 1.0 if inverse else -1.0
    m = n
    while m > 1:
        m2 = m // 2
        a, b = y[:, :, :m2], y[:, :, m2:]
        k = torch.arange(m2, dtype=torch.float64, device=x.device)
        ang = (sign * math.pi) * (2.0 * k / m)
        w = torch.complex(torch.cos(ang), torch.sin(ang)).to(torch.complex64)
        y = torch.cat([a + b, (a - b) * w], dim=1)
        m = m2
    y = y.reshape(rows, n)
    if inverse:
        y = y * (1.0 / n)
    return y
