"""Batched FFT over complex64 rows (the paper's FFT accelerator, §4.1).

Two versions of one function, rows of complex64 along the last axis:

* :func:`fft_kernel` launches the hand-written CUDA kernel
  (``csrc/fft.cu``): Stockham passes of radix 8 (N <= 512) or 16 (a
  smaller last radix), each thread holding 8 or 16 values in registers,
  shared memory only between passes, twiddles read coalesced from
  :func:`pass_twiddles` (gathered from one table of the 8192 roots);
  :func:`launch_plan` gives its launch geometry.  Above :data:`TABLE_N`
  it is two launches (one call, one count): the four-step FFT over
  N = N1 N2 (:func:`split`), N1-point FFTs down the columns times the
  step twiddles (:func:`step_twiddles`) into a workspace, then N2-point
  FFTs along its rows into natural order (the geometry is N's alone, and
  ``csrc/fft.cu`` derives it; a block's lines sit in shared memory at
  :func:`tile_slot`, which keeps its copies free of bank conflicts);
* :func:`fft_plain` is the radix-2 Stockham recurrence in torch ops
  (slice, butterfly, ``cat``) — what a CPU tensor runs, and what the
  kernel is held against on the card.

Both produce natural order with no bit reversal, and both compute the
inverse with a 1/N scale, which equals ``conj(fft(conj x))/N``.
Supports power-of-two N from 2 to 2**21 (:data:`MAX_POW2`); any other
length up to :data:`MAX_N` goes through :mod:`.bluestein` (on the card
one call of ``csrc/fft.cu``'s Bluestein entry), whose inner transforms
reach 2**21.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from .._build import check, launch, library

__all__ = ["BLOCK_ROWS", "MAX_N", "MAX_POW2", "TABLE_N", "TILE", "tile",
           "swizzle", "tile_slot", "BLOCK_THREADS",
           "MAX_THREADS", "values", "radices", "launch_plan",
           "pass_twiddles", "twiddle_tables", "split", "step_twiddles",
           "step_table", "fft_kernel", "fft_plain", "launches"]

#: rows each thread block walks (a pure launch parameter: no row's
#: arithmetic depends on the rows beside it, so every value gives
#: bit-identical output)
BLOCK_ROWS = 8
#: longest row the op takes at any length (``ops.fft``: powers of two
#: here, other lengths through :mod:`.bluestein`)
MAX_N = 1 << 20
#: largest power of two the kernel takes: Bluestein's inner length for N
#: above 2**19
MAX_POW2 = 1 << 21
#: roots in the twiddle table: exp(-2 pi i k / TABLE_N), k < TABLE_N; also
#: the largest N of one launch (longer rows take the four-step passes)
TABLE_N = 8192
#: lines (columns, then workspace rows) a four-step block takes side by
#: side: 8 complex64 values, a 64-byte run of each strided access
TILE = 8


def tile(length: int) -> int:
    """Lines a four-step block takes side by side for lines of ``length``:
    :data:`TILE`, and half as many for lines of 2048 (pass 1 of 2**21),
    where 8 would need 1024 threads and 256 KB (``csrc/fft.cu``
    ``tile_log``)."""
    return TILE if length <= 1024 else TILE // 2


def swizzle(g: int, n: int) -> int:
    """Where shared index ``g`` of a block's rows of ``n`` is stored
    (``csrc/fft.cu`` ``Plan::swz``): g ^ ((g / V) mod 16), V =
    :func:`values` (n), which keeps every exchange between passes free of
    bank conflicts."""
    vlog = values(n).bit_length() - 1
    return g ^ ((g >> vlog) & 15)


def tile_slot(c: int, e: int, length: int) -> int:
    """Where element ``e`` of line ``c`` of a four-step block over lines
    of ``length`` is stored (``csrc/fft.cu`` ``tile_xor``): the rows'
    :func:`swizzle` of c length + e with c 16 / :func:`tile` (length)
    XORed into its bank bits.  A strided tile copy's half-warp touches
    16 / TILE elements of each of its TILE lines: the rows' swizzle alone
    puts a line's element at one bank pair whatever the line, the XOR
    spreads the lines over distinct ones."""
    return swizzle(c * length + e, length) ^ ((c * (16 // tile(length)))
                                              & 15)


#: threads a block of short rows fills at least (rows allowing), and the
#: most a block has (the kernel's launch bound)
BLOCK_THREADS, MAX_THREADS = 256, 512

#: kernel launches since the count was last set to 0
launches = 0
_count_lock = threading.Lock()
_table_lock = threading.Lock()
#: CUDA device index (or the device's name) -> :func:`twiddle_tables`
_tables = {}
#: (CUDA device index or the device's name, N) -> :func:`step_table`
_step_tables = {}


def values(n: int) -> int:
    """Values each thread of the kernel holds for rows of ``n``: 8 up to
    n = 512 (more threads a row, shorter serial work for the one-row
    calls of the radar path), 16 above (fewer passes), n up to n = 8."""
    return n if n <= 8 else 8 if n <= 512 else 16


def radices(n: int):
    """The kernel's passes over a row of ``n`` (a power of two from 2 to
    :data:`TABLE_N`): radix ``values(n)`` each, the last one
    2 ** (log2 n mod log2 values(n)) when that is not 1 —
    ceil(log2 n / log2 values(n)) passes (``csrc/fft.cu`` derives the same
    plan from log2 n at compile time)."""
    p = n.bit_length() - 1
    b = values(n).bit_length() - 1
    return [1 << b] * (p // b) + ([1 << (p % b)] if p % b else [])


@functools.lru_cache(maxsize=4096)
def launch_plan(n: int, rows: int, block_rows: int):
    """``(threads, rows_per_group, groups_per_block, grid, smem_bytes)`` of
    the kernel for ``rows`` rows of ``n``.  A row has n / values(n)
    threads.  A block covers ``block_rows`` rows, or as many as fill
    :data:`BLOCK_THREADS` threads if that is more; it takes them side by
    side as far as :data:`MAX_THREADS` threads allow (a group, never more
    rows than there are) and walks the groups one after another.  Shared
    memory: two buffers of a group's rows, none for one pass."""
    per_row = n // values(n)
    covered = max(block_rows, BLOCK_THREADS // per_row)
    rpg = max(1, min(covered, MAX_THREADS // per_row, rows))
    gpb = -(-covered // rpg)
    grid = -(-rows // (rpg * gpb))
    smem = 0 if len(radices(n)) == 1 else 2 * rpg * n * 8
    return rpg * per_row, rpg, gpb, grid, smem


def _roots() -> np.ndarray:
    """The :data:`TABLE_N` roots ``exp(-2 pi i k / TABLE_N)``, computed in
    float64 and rounded to complex64."""
    k = np.arange(TABLE_N, dtype=np.float64)
    return np.exp(-2j * np.pi * k / TABLE_N).astype(np.complex64)


def pass_twiddles(n: int) -> np.ndarray:
    """The kernel's twiddles for rows of ``n``, gathered from
    :func:`_roots` in the order its threads read them: for each pass
    q >= 1 of radix R over sub-length Ns (the product of the radices
    before it), and for each butterfly i < V / R and input 1 <= r < R
    (V = values(n)), one entry per thread t < T = n / V: ``w(r k, Ns R)``
    with ``k = (t + i T) mod Ns``, entry ``r k TABLE_N / (Ns R)`` of the
    roots.  Empty for a single pass (n <= 8)."""
    if n <= 8:
        return np.zeros(0, np.complex64)
    rad = radices(n)
    roots = _roots()
    values = rad[0]
    t = np.arange(n // values)
    out, ns = [], values
    for radix in rad[1:]:
        step = TABLE_N // (ns * radix)
        for i in range(values // radix):
            k = (t + i * len(t)) & (ns - 1)
            out += [roots[r * k * step] for r in range(1, radix)]
        ns *= radix
    return np.concatenate(out)


def twiddle_tables(device):
    """``(tensor, pointers)`` on ``device``: every N's :func:`pass_twiddles`
    in one complex64 tensor, and the address of N's part at index
    log2 N (the tensor's start where N has one pass).  Built once per
    device, under a lock, and kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = device.index if device.type == "cuda" else str(device)
    entry = _tables.get(key)
    if entry is None:
        with _table_lock:
            entry = _tables.get(key)
            if entry is None:
                parts = [pass_twiddles(1 << p)
                         for p in range(TABLE_N.bit_length())]
                offsets = np.cumsum([0] + [len(x) for x in parts])
                table = torch.from_numpy(np.concatenate(parts)).to(device)
                base = table.data_ptr()
                entry = (table, [base + 8 * int(o) for o in offsets[:-1]])
                _tables[key] = entry
    return entry


def split(n: int):
    """``(N1, N2)`` of the four-step FFT of a row of ``n`` (a power of two
    above :data:`TABLE_N`): N1 = 2 ** ceil(p / 2) rows of N2 =
    2 ** floor(p / 2), p = log2 n -- both at most 1024 up to 2**20, and
    2048 x 1024 at :data:`MAX_POW2`."""
    p = n.bit_length() - 1
    return 1 << (p - p // 2), 1 << (p // 2)


def step_twiddles(n: int) -> np.ndarray:
    """The four-step's step twiddles for rows of ``n``: entry
    ``k1 N2 + n2`` is ``w_n^(n2 k1) = exp(-2 pi i n2 k1 / n)``, laid out
    as the workspace element it multiplies, computed in float64 and
    rounded to complex64 once."""
    n1, n2 = split(n)
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    c = np.arange(n2, dtype=np.float64)[None, :]
    return np.exp(-2j * np.pi * (k1 * c) / n).astype(np.complex64).ravel()


def step_table(device, n: int) -> torch.Tensor:
    """:func:`step_twiddles` of ``n`` on ``device``, built once per
    device and N, under a lock, and kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.index if device.type == "cuda" else str(device), n)
    table = _step_tables.get(key)
    if table is None:
        with _table_lock:
            table = _step_tables.get(key)
            if table is None:
                table = torch.from_numpy(step_twiddles(n)).to(device)
                _step_tables[key] = table
    return table


class _Launch(ctypes.Structure):
    """One call's geometry, ``FftLaunch`` of ``csrc/fft.cu``."""

    _fields_ = [("twiddles", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("grid", ctypes.c_longlong), ("n", ctypes.c_int),
                ("inverse", ctypes.c_int), ("threads", ctypes.c_int),
                ("rows_per_group", ctypes.c_int),
                ("groups_per_block", ctypes.c_int), ("smem", ctypes.c_int)]


class _Launch4(ctypes.Structure):
    """One four-step call's tables, ``Fft4Launch`` of ``csrc/fft.cu``
    (which derives the geometry from N)."""

    _fields_ = [("twiddles1", ctypes.c_void_p), ("twiddles2", ctypes.c_void_p),
                ("step", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("n", ctypes.c_int), ("inverse", ctypes.c_int)]


@functools.lru_cache(maxsize=4096)
def _launch4_args(index: int, n: int, rows: int, inverse: bool):
    """(address, structure, tables) of the :class:`_Launch4` for a call on
    CUDA device ``index`` (-1: the CPU's tables), built once and kept with
    the tables it points into."""
    n1, n2 = split(n)
    device = torch.device("cuda", index) if index >= 0 else "cpu"
    table, ptrs = twiddle_tables(device)
    step = step_table(device, n)
    args = _Launch4(ptrs[n1.bit_length() - 1], ptrs[n2.bit_length() - 1],
                    step.data_ptr(), rows, n, int(inverse))
    return ctypes.addressof(args), args, (table, step)


@functools.lru_cache(maxsize=4096)
def _launch_args(index: int, n: int, rows: int, block_rows: int,
                 inverse: bool):
    """(address, structure, twiddle table) of the :class:`_Launch` for a
    call on CUDA device ``index`` (-1: the CPU's tables), built once and
    kept with the table it points into, so a launch hands the kernel one
    pointer instead of converting nine values."""
    threads, rpg, gpb, grid, smem = launch_plan(n, rows, block_rows)
    device = torch.device("cuda", index) if index >= 0 else "cpu"
    table, ptrs = twiddle_tables(device)
    args = _Launch(ptrs[n.bit_length() - 1], rows, grid, n, int(inverse),
                   threads, rpg, gpb, smem)
    return ctypes.addressof(args), args, table


def fft_kernel(x: torch.Tensor, *, inverse: bool = False,
               block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """x: contiguous complex64 on a CUDA device, its last axis a power of
    two N from 2 to :data:`MAX_POW2` → the FFT (or inverse FFT) of every
    length-N row, in a fresh tensor of x's shape.  The caller has
    validated x; this launches on the current stream and does not
    wait.  Above :data:`TABLE_N` the two four-step launches count as one
    call and ``block_rows`` has no effect (the geometry is N's alone)."""
    global launches
    n = x.shape[-1]
    rows = x.numel() // n
    out = torch.empty_like(x)
    if rows == 0:
        return out
    if n > TABLE_N:
        work = torch.empty_like(x)
        args = _launch4_args(x.get_device(), n, rows, inverse)
        check(launch(library().rimms_fft4_c64, x, x.data_ptr(),
                     out.data_ptr(), work.data_ptr(), args[0]), "fft")
    else:
        args = _launch_args(x.get_device(), n, rows, block_rows, inverse)
        check(launch(library().rimms_fft_c64, x, x.data_ptr(),
                     out.data_ptr(), args[0]), "fft")
    with _count_lock:
        launches += 1
    return out


def fft_plain(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """The radix-2 Stockham recurrence in torch ops.
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
