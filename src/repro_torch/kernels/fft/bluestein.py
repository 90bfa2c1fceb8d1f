"""The DFT at any length N from the port's own power-of-two FFT and ZIP
(Bluestein's chirp-z algorithm).

With w_k = exp(∓iπ k² / N) (the sign of the direction), nk = (n² + k² -
(k - n)²) / 2 turns the DFT into a convolution:

    X_k = w_k Σ_n (x_n w_n) conj(w_{k-n}),

which a circular convolution of length M >= 2N - 1 (the next power of two)
computes exactly.  A call is six steps, each one kernel launch on the card
(:func:`bluestein`): multiply by the chirp (ZIP), zero-pad to M, FFT of
length M, multiply by the filter's spectrum (ZIP), inverse FFT of length
M, multiply by the chirp again and keep the first N values (ZIP) -- two
FFT and three ZIP launches.  The inner inverse scales by 1/M, which the
convolution needs and nothing more; the inverse DFT's 1/N is folded into
the filter before its spectrum is taken.

The chirp's angle is π (k² mod 2N) / N, with k² mod 2N taken in int64 and
the angle in float64, rounded to complex64 once: k² in float32 loses the
phase once k passes a few thousand.  The filter's spectrum is taken by the
port's own FFT (the kernel on the card, its plain version on the CPU) once
per (N, direction, device) and kept, as ``fft.twiddle_tables`` are.  A
call's workspace is rows x M complex64 a buffer: at 1 x (2^20 - 1), M is
2^21 and a buffer 16 MiB (the padded input, the inner transforms' outputs
and four-step workspace, the products).  Every step is bit-identical across
the FFT's ``block_rows``, so the composition is too.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..zip.zip import zip_kernel, zip_plain
from .fft import fft_kernel, fft_plain

__all__ = ["inner_length", "chirp", "filter_taps", "tables", "bluestein",
           "bluestein_kernel", "bluestein_plain"]

_lock = threading.Lock()
#: (N, inverse, CUDA device index or the device's name) -> (chirp, spectrum)
_tables = {}


def inner_length(n: int) -> int:
    """M: the least power of two >= 2n - 1 (a circular convolution of
    that length holds the linear one of two length-n sequences)."""
    return 1 << (2 * n - 2).bit_length()


def chirp(n: int, inverse: bool) -> np.ndarray:
    """w_k = exp(s iπ (k² mod 2n) / n), k < n, s = -1 forward and +1
    inverse: k² mod 2n in int64, the angle in float64, rounded to
    complex64 once."""
    k = np.arange(n, dtype=np.int64)
    ang = np.pi * ((k * k) % (2 * n)).astype(np.float64) / n
    return np.exp((1j if inverse else -1j) * ang).astype(np.complex64)


def filter_taps(n: int, inverse: bool) -> np.ndarray:
    """The convolution's filter, length M: conj(w_m) at m and at M - m
    (m < n), zeros between, times 1/n for the inverse -- in float64,
    rounded to complex64 once."""
    m = inner_length(n)
    k = np.arange(n, dtype=np.int64)
    ang = np.pi * ((k * k) % (2 * n)).astype(np.float64) / n
    taps = np.exp((-1j if inverse else 1j) * ang)
    if inverse:
        taps = taps / n
    b = np.zeros(m, np.complex128)
    b[:n] = taps
    b[m - n + 1:] = taps[1:][::-1]
    return b.astype(np.complex64)


def tables(n: int, inverse: bool, device):
    """``(chirp, spectrum)`` on ``device``: :func:`chirp` (n,) and the
    forward FFT of :func:`filter_taps` (M,), taken by the port's FFT --
    the kernel on a CUDA device (one launch, counted, waited for before
    the tables are shared, since another thread's stream may read them
    next), the plain version on the CPU.  Built once per (n, direction,
    device), under a lock, and kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (n, bool(inverse),
           device.index if device.type == "cuda" else str(device))
    entry = _tables.get(key)
    if entry is None:
        with _lock:
            entry = _tables.get(key)
            if entry is None:
                w = torch.from_numpy(chirp(n, inverse)).to(device)
                taps = torch.from_numpy(filter_taps(n, inverse)).to(device)
                taps = taps.reshape(1, -1)
                if device.type == "cuda":
                    spec = fft_kernel(taps).reshape(-1)
                    # published to every stream: wait for this one's launch
                    torch.cuda.current_stream(device).synchronize()
                else:
                    spec = fft_plain(taps).reshape(-1)
                entry = (w, spec)
                _tables[key] = entry
    return entry


def bluestein(x: torch.Tensor, *, inverse: bool, fft, mul) -> torch.Tensor:
    """The DFT (or the inverse DFT, scaled by 1/N) of each row of x
    (rows, N), complex64, contiguous, through ``fft(a, inverse)`` (a
    power-of-two FFT along the last axis) and ``mul(a, b)`` (a pointwise
    product of one shape).  Returns a fresh (rows, N) tensor."""
    rows, n = x.shape
    m = inner_length(n)
    w, spec = tables(n, inverse, x.device)
    # one row takes the tables as they are; more rows a copy of them a row
    wr = w.expand(rows, n).contiguous()
    a = x.new_zeros((rows, m))
    a[:, :n] = mul(x, wr)
    y = fft(a, False)
    y = mul(y, spec.expand(rows, m).contiguous())
    y = fft(y, True)
    return mul(y[:, :n].contiguous(), wr)


def bluestein_kernel(x: torch.Tensor, *, inverse: bool,
                     block_rows: int) -> torch.Tensor:
    """:func:`bluestein` on the card: x (rows, N) contiguous complex64 on
    a CUDA device; two launches of the FFT kernel (with ``block_rows``)
    and three of ZIP, on the current stream, without waiting."""
    return bluestein(
        x, inverse=inverse,
        fft=lambda a, inv: fft_kernel(a, inverse=inv, block_rows=block_rows),
        mul=zip_kernel)


def bluestein_plain(x: torch.Tensor, *, inverse: bool) -> torch.Tensor:
    """:func:`bluestein` over the plain versions: what a CPU tensor runs,
    and what the card's composition is held against."""
    return bluestein(x, inverse=inverse,
                     fft=lambda a, inv: fft_plain(a, inverse=inv),
                     mul=zip_plain)
