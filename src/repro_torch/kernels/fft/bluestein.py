"""The DFT at any length N from the port's own power-of-two FFT
(Bluestein's chirp-z algorithm).

With w_k = exp(∓iπ k² / N) (the sign of the direction), nk = (n² + k² -
(k - n)²) / 2 turns the DFT into a convolution:

    X_k = w_k Σ_n (x_n w_n) conj(w_{k-n}),

which a circular convolution of length M >= 2N - 1 (the next power of two)
computes exactly.  :func:`bluestein` writes it as six steps over an FFT
and a pointwise product: multiply by the chirp, zero-pad to M, FFT of
length M, multiply by the filter's spectrum, inverse FFT of length M,
multiply by the chirp again and keep the first N values.  The inner
inverse scales by 1/M, which the convolution needs and nothing more; the
inverse DFT's 1/N is folded into the filter before its spectrum is taken.
Over the plain versions (:func:`bluestein_plain`) that is what a CPU
tensor runs.

On the card (:func:`bluestein_kernel`) a call is one C entry of
``csrc/fft.cu`` (``rimms_bluestein_c64``), one FFT launch count and no ZIP
count: up to M = 8192 (N <= 4096) one kernel launch that keeps a row on
the chip from the chirp's product to the last store, above it four
four-step launches with the three products folded into their loads and
stores.  It does the arithmetic of the six steps over the FFT and ZIP
kernels, in their order, so its output has their bits (``chip_smoke.py``
phase 3 holds it to that composition with ``torch.equal``), and it never
falls back to the composition: a refused launch raises.

The chirp's angle is π (k² mod 2N) / N, with k² mod 2N taken in int64 and
the angle in float64, rounded to complex64 once: k² in float32 loses the
phase once k passes a few thousand.  The filter's spectrum is taken by the
port's own FFT (the kernel on the card, its plain version on the CPU) once
per (N, direction, device) and kept, as ``fft.twiddle_tables`` are.  A
call's workspace on the card: none up to M = 8192; above, two buffers of
rows x M complex64 (the four-step's workspace and the forward transform),
32 MiB at 1 x (2^20 - 1).  Every launch is bit-identical across the FFT's
``block_rows``, so a call is too.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from .._build import check, launch, library
from ..zip.zip import zip_plain
from . import fft as _fft
from .fft import (TABLE_N, fft_kernel, fft_plain, launch_plan, split,
                  step_table, twiddle_tables)

__all__ = ["inner_length", "chirp", "filter_taps", "tables", "bluestein",
           "launch_geometry", "bluestein_kernel", "bluestein_plain"]

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


def launch_geometry(n: int, rows: int, block_rows: int):
    """``(threads, rows_per_group, groups_per_block, grid, smem_bytes)`` of
    the one launch for ``rows`` rows of ``n`` (M = :func:`inner_length`
    up to :data:`TABLE_N`): ``fft.launch_plan`` of M, with two shared
    buffers of a group's rows even for one pass (the forward transform
    waits there for the inverse).  None above, where the four-step's
    geometry is M's alone and the C entry derives it."""
    m = inner_length(n)
    if m > TABLE_N:
        return None
    threads, rpg, gpb, grid, _ = launch_plan(m, rows, block_rows)
    return threads, rpg, gpb, grid, 2 * rpg * m * 8


class _Launch(ctypes.Structure):
    """One call's tables and geometry, ``BluesteinLaunch`` of
    ``csrc/fft.cu``."""

    _fields_ = [("twiddles1", ctypes.c_void_p), ("twiddles2", ctypes.c_void_p),
                ("step", ctypes.c_void_p), ("chirp", ctypes.c_void_p),
                ("spectrum", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("grid", ctypes.c_longlong), ("n", ctypes.c_int),
                ("m", ctypes.c_int), ("threads", ctypes.c_int),
                ("rows_per_group", ctypes.c_int),
                ("groups_per_block", ctypes.c_int), ("smem", ctypes.c_int)]


@functools.lru_cache(maxsize=4096)
def _launch_args(index: int, n: int, rows: int, block_rows: int,
                 inverse: bool):
    """(address, structure, tables) of the :class:`_Launch` for a call on
    CUDA device ``index`` (-1: the CPU's tables): M's pass table (M1's and
    M2's and the step table above :data:`TABLE_N`), the chirp and the
    spectrum of (n, direction), and the geometry; built once and kept
    with the tables it points into."""
    m = inner_length(n)
    device = torch.device("cuda", index) if index >= 0 else "cpu"
    w, spec = tables(n, inverse, device)
    table, ptrs = twiddle_tables(device)
    geometry = launch_geometry(n, rows, block_rows)
    if geometry is not None:
        threads, rpg, gpb, grid, smem = geometry
        args = _Launch(ptrs[m.bit_length() - 1], None, None, w.data_ptr(),
                       spec.data_ptr(), rows, grid, n, m, threads, rpg, gpb,
                       smem)
        return ctypes.addressof(args), args, (table, w, spec)
    m1, m2 = split(m)
    step = step_table(device, m)
    args = _Launch(ptrs[m1.bit_length() - 1], ptrs[m2.bit_length() - 1],
                   step.data_ptr(), w.data_ptr(), spec.data_ptr(), rows, 0,
                   n, m, 0, 0, 0, 0)
    return ctypes.addressof(args), args, (table, step, w, spec)


def bluestein_kernel(x: torch.Tensor, *, inverse: bool,
                     block_rows: int) -> torch.Tensor:
    """:func:`bluestein` on the card: x (rows, N) contiguous complex64 on
    a CUDA device -> a fresh (rows, N) tensor, by one call of
    ``rimms_bluestein_c64`` on the current stream, without waiting (one
    FFT launch count; ``block_rows`` as the FFT kernel's, up to M =
    8192).  Raises if the launch is refused."""
    rows, n = x.shape
    out = torch.empty_like(x)
    if rows == 0:
        return out
    m = inner_length(n)
    args = _launch_args(x.get_device(), n, rows, block_rows, inverse)
    work = x.new_empty((2 * rows, m)) if m > TABLE_N else None
    check(launch(library().rimms_bluestein_c64, x, x.data_ptr(),
                 out.data_ptr(), None if work is None else work.data_ptr(),
                 args[0]), "fft")
    with _fft._count_lock:
        _fft.launches += 1
    return out


def bluestein_plain(x: torch.Tensor, *, inverse: bool) -> torch.Tensor:
    """:func:`bluestein` over the plain versions: what a CPU tensor runs,
    and what the card's route is held against within tolerance."""
    return bluestein(x, inverse=inverse,
                     fft=lambda a, inv: fft_plain(a, inverse=inv),
                     mul=zip_plain)
