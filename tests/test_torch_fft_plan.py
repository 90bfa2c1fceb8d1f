"""The FFT kernel's host-side plan and the kernels' launch helper, on the CPU.

The CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); what the wrappers compute in Python before a
launch -- the twiddle table, the pass plan, the launch geometry -- and the
launch helper's device guard are checked here.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fft import fft as F

torch.set_num_threads(1)

#: the card's limits (H100): threads a block, shared memory a block can
#: opt in to, blocks in the grid's x dimension
MAX_BLOCK_THREADS = 1024
MAX_SMEM = 232448
MAX_GRID_X = 2 ** 31 - 1
#: the kernel's own launch bound (csrc/fft.cu kMaxThreads)
KERNEL_MAX_THREADS = 512

ROWS = (1, 3, 128, 1024)
NS = [2 ** p for p in range(1, 14)]


def test_roots_are_rounded_to_float32():
    roots = F._roots()
    assert roots.dtype == np.complex64 and roots.shape == (F.TABLE_N,)
    k = np.arange(F.TABLE_N)
    exact = np.exp(-2j * np.pi * k / F.TABLE_N)  # complex128
    # each component is the float32 nearest the float64 root
    np.testing.assert_array_equal(roots.real, exact.real.astype(np.float32))
    np.testing.assert_array_equal(roots.imag, exact.imag.astype(np.float32))
    assert np.max(np.abs(roots - exact)) < 2 ** -24


@pytest.mark.parametrize("n", NS)
def test_pass_twiddles_are_roots_in_thread_order(n):
    """Entry (q, e, t) of N's pass table is w(r k, Ns R), the root
    r k TABLE_N / (Ns R), for butterfly i = e // (R - 1), input
    r = e % (R - 1) + 1 and k = (t + i T) mod Ns -- in the order the
    kernel's threads read them."""
    roots = F._roots()
    got = F.pass_twiddles(n)
    rad = F.radices(n)
    if len(rad) == 1:
        assert got.size == 0
        return
    values, threads = rad[0], n // rad[0]
    pos, ns = 0, values
    for radix in rad[1:]:
        m = ns * radix
        for e in range((values // radix) * (radix - 1)):
            i, r = divmod(e, radix - 1)
            r += 1
            k = (np.arange(threads) + i * threads) % ns
            part = got[pos:pos + threads]
            np.testing.assert_array_equal(part, roots[r * k * F.TABLE_N // m])
            exact = np.exp(-2j * np.pi * r * k / m)
            assert np.max(np.abs(part - exact)) < 2 ** -24
            pos += threads
        ns = m
    assert pos == got.size  # csrc/fft.cu tw_offset: (V - V / R) T a pass


def test_twiddle_tables_built_once_per_device():
    table, ptrs = F.twiddle_tables("cpu")
    assert F.twiddle_tables("cpu")[0] is table
    assert table.dtype == torch.complex64 and len(ptrs) == 14
    for p in range(1, 14):
        part = F.pass_twiddles(1 << p)
        off = (ptrs[p] - table.data_ptr()) // 8
        assert torch.equal(table[off:off + part.size],
                           torch.from_numpy(part))


@pytest.mark.parametrize("n", NS)
def test_radix_plan(n):
    """ceil(log2 n / log2 V) passes of radix V -- 8 up to n = 512, 16
    above -- but for a smaller last one, whose product is n."""
    v = F.values(n)
    r = F.radices(n)
    assert v == (n if n <= 8 else 8 if n <= 512 else 16)
    assert math.prod(r) == n
    assert len(r) == -(-int(math.log2(n)) // int(math.log2(v)))
    assert all(x == v for x in r[:-1]) and 2 <= r[-1] <= v
    assert len(r) == 1 or v >= 8  # every multi-pass row: radix >= 8


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("block_rows", [8, 32, 128])
def test_launch_geometry_within_card_limits(n, block_rows):
    per_row = n // F.values(n)  # threads a row
    for rows in ROWS:
        threads, rpg, gpb, grid, smem = F.launch_plan(n, rows, block_rows)
        assert threads == rpg * per_row
        assert 1 <= threads <= F.MAX_THREADS == KERNEL_MAX_THREADS
        assert threads <= MAX_BLOCK_THREADS
        assert threads == per_row or threads >= min(
            F.BLOCK_THREADS, rows * per_row)  # short rows fill a block
        assert 1 <= rpg <= rows and gpb >= 1
        assert rpg * gpb >= min(block_rows, rows)  # a block covers them
        # every row has a block, and no block is empty
        assert grid * gpb * rpg >= rows > (grid - 1) * gpb * rpg
        assert 1 <= grid <= MAX_GRID_X
        assert 0 <= smem <= MAX_SMEM
        if len(F.radices(n)) == 1:
            assert smem == 0  # one pass: registers only
        else:  # two buffers of the group's rows
            assert smem == 2 * rpg * n * 8


def test_twiddle_tables_one_build_under_racing_threads(monkeypatch):
    """Threads that ask for a device's tables at once all get the one
    table built (the thread backend runs PEs in threads)."""
    import threading

    monkeypatch.setattr(F, "_tables", {})
    got, start = [], threading.Barrier(8)

    def ask():
        start.wait(timeout=30)
        got.append(F.twiddle_tables("cpu")[0])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got)


@pytest.mark.parametrize("n", [2, 256, 2048, 8192])
@pytest.mark.parametrize("inverse", [False, True])
def test_launch_args_carry_the_plan(n, inverse):
    """The structure a launch hands the kernel by address (``FftLaunch``
    of csrc/fft.cu: a pointer, two int64, six int32) holds the plan and
    N's part of the twiddle tables, and is built once per call shape."""
    import ctypes

    addr, args, table = F._launch_args(-1, n, 1024, 8, inverse)
    assert ctypes.sizeof(args) == 48 and addr == ctypes.addressof(args)
    threads, rpg, gpb, grid, smem = F.launch_plan(n, 1024, 8)
    assert (args.rows, args.grid, args.n, args.inverse) == (
        1024, grid, n, int(inverse))
    assert (args.threads, args.rows_per_group, args.groups_per_block,
            args.smem) == (threads, rpg, gpb, smem)
    assert table is F.twiddle_tables("cpu")[0]
    assert args.twiddles == F.twiddle_tables("cpu")[1][n.bit_length() - 1]
    assert F._launch_args(-1, n, 1024, 8, inverse)[1] is args


def _exchange_conflicts(n, rpg):
    """Worst bank-conflict degree of the shared-memory exchanges of
    ``csrc/fft.cu`` for a block of ``rpg`` rows of ``n``: pass q of radix R
    over sub-length Ns writes y[(j / Ns) Ns R + j mod Ns + r Ns] and the
    next pass reads x[j + r n / R]; shared index g of the block's rows is
    stored at g ^ ((g / V) mod 16) (V values a thread), and 8-byte
    accesses conflict within a half-warp when two distinct addresses share
    a bank pair (index mod 16)."""
    r_all = F.radices(n)
    values = F.values(n)
    vlog = values.bit_length() - 1
    per_row = n // values
    threads = rpg * per_row
    worst, ns = 1, 1

    def degree(addrs):
        out = 1
        for half in (addrs[:16], addrs[16:]):
            banks = {}
            for a in half:
                banks.setdefault(a % 16, set()).add(a)
            out = max([out] + [len(v) for v in banks.values()])
        return out

    for q, radix in enumerate(r_all):
        for i in range(values // radix):
            for r in range(radix):
                for w0 in range(0, threads, 32):
                    reads, writes = [], []
                    for tid in range(w0, min(w0 + 32, threads)):
                        row, t = divmod(tid, per_row)
                        j = t + i * per_row
                        src = row * n + j + r * (n // radix)
                        dst = row * n + (j // ns) * ns * radix + j % ns \
                            + r * ns
                        reads.append(src ^ ((src >> vlog) & 15))
                        writes.append(dst ^ ((dst >> vlog) & 15))
                    if q > 0:
                        worst = max(worst, degree(reads))
                    if q < len(r_all) - 1:
                        worst = max(worst, degree(writes))
        ns *= radix
    return worst


@pytest.mark.parametrize("n", [2 ** p for p in range(4, 14)])
def test_swizzled_exchange_has_no_bank_conflicts(n):
    for rows in (1, 3, 1024):
        rpg = F.launch_plan(n, rows, 8)[1]
        assert _exchange_conflicts(n, rpg) == 1


def test_launch_helper_does_nothing_at_import():
    """Importing the build module and a wrapper builds nothing, loads no
    library, makes no table and needs no CUDA."""
    code = ("import sys; sys.path.insert(0, 'src');"
            "from repro_torch.kernels import _build;"
            "from repro_torch.kernels.fft import fft as F;"
            "from repro_torch.kernels.zip import zip as Z;"
            "assert callable(_build.launch) and callable(_build.raw_stream);"
            "assert _build._lib is None and _build.build_log == '';"
            "assert F._tables == {} and F.launches == Z.launches == 0;"
            "print('clean')")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


class _FakeCudaTensor:
    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


@pytest.mark.parametrize("current,index,guarded", [(0, 0, False),
                                                   (0, 1, True),
                                                   (1, 1, False)])
def test_launch_passes_raw_stream_and_guards_only_another_device(
        monkeypatch, current, index, guarded):
    """``launch`` appends the raw stream of the tensor's device and enters
    a device guard only when that device is not the current one."""
    entered = []

    class Guard:
        def __init__(self, i):
            self.i = i

        def __enter__(self):
            entered.append(self.i)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 1000 + i, raising=False)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    calls = []
    status = _build.launch(lambda *a: calls.append(a) or 0,
                           _FakeCudaTensor(index), 7, "x")
    assert status == 0
    assert calls == [(7, "x", 1000 + index)]
    assert entered == ([index] if guarded else [])
    assert _build.raw_stream(_FakeCudaTensor(index)) == 1000 + index


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape", [(64,), (2, 3, 32)])
def test_cpu_path_keeps_shape_and_matches_pallas(shape, forward):
    """The CPU path (the plain version) reshapes to rows and back (the
    kernel path takes the shape as it is) and agrees with the JAX
    package's Pallas kernel (interpret mode) on the same numpy input."""
    from repro.kernels.fft import ops as jfft_ops
    from repro_torch.kernels.fft import ops

    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    out = ops.fft(torch.from_numpy(x), forward)
    assert out.shape == shape and out.dtype == torch.complex64
    want = np.asarray(jfft_ops.fft(x, forward=forward))
    # the tolerance is sized for forward outputs: an inverse times n
    s = 1 if forward else shape[-1]
    np.testing.assert_allclose(out.numpy() * s, want * s, rtol=5e-4,
                               atol=5e-4 * math.sqrt(shape[-1]))


# ------------------------------------------------------- four-step plan
#: N past one launch: the four-step passes (csrc/fft.cu fft_four_step)
NS4 = [2 ** p for p in range(14, 21)]


def test_max_n_and_the_split_point():
    assert F.MAX_N == 2 ** 20 and F.TABLE_N == 8192 and F.TILE == 8


@pytest.mark.parametrize("n", NS4)
def test_four_step_split(n):
    """N = N1 N2 with N1 = 2^ceil(p/2) >= N2 = 2^floor(p/2): both lines
    take more than one register pass (the tile kernel's passes start
    from shared memory) and at most 1024 values (a block of TILE lines
    fits in shared memory)."""
    n1, n2 = F.split(n)
    assert n1 * n2 == n and n1 in (n2, 2 * n2)
    for length in (n1, n2):
        assert 128 <= length <= 1024
        assert len(F.radices(length)) >= 2


def _four_step_geometry(n, rows):
    """``(threads, grid, smem)`` of both four-step passes as
    ``rimms_fft4_c64`` derives them from N: pass 1 takes the N2 columns
    of each row (N1 long), pass 2 the N1 workspace rows (N2 long),
    :data:`F.TILE` lines a block with a line's threads each and two
    shared buffers of them."""
    n1, n2 = F.split(n)

    def geometry(length, lines):
        return (F.TILE * (length // F.values(length)),
                rows * (lines // F.TILE), 2 * F.TILE * length * 8)

    return geometry(n1, n2), geometry(n2, n1)


@pytest.mark.parametrize("n", NS4)
def test_four_step_plan_within_card_limits(n):
    """The geometry the C entry derives fits the card at every N it takes
    and at every row count the sweeps use (grid up to 2^20 rows)."""
    for rows in ROWS + (2 ** 20,):
        for threads, grid, smem in _four_step_geometry(n, rows):
            assert 1 <= threads <= KERNEL_MAX_THREADS
            assert 1 <= grid <= MAX_GRID_X
            assert smem <= MAX_SMEM


@pytest.mark.parametrize("n", [2 ** 14, 2 ** 20])
def test_four_step_call_takes_one_workspace_of_the_input_shape(
        monkeypatch, n):
    """A four-step call makes its output and one workspace, both of x's
    shape and type, and hands the kernel three distinct buffers (the
    library and the launch are stand-ins, so this runs on the CPU)."""
    made, calls = [], []
    empty_like = torch.empty_like

    def spy(t, *a, **k):
        made.append(empty_like(t, *a, **k))
        return made[-1]

    class Lib:
        rimms_fft4_c64 = "fft4"

    monkeypatch.setattr(torch, "empty_like", spy)
    monkeypatch.setattr(F, "library", lambda: Lib)
    monkeypatch.setattr(F, "launch",
                        lambda fn, t, *a: calls.append((fn, a)) or 0)
    x = torch.zeros(3, n, dtype=torch.complex64)
    out = F.fft_kernel(x)
    assert len(made) == 2 and out is made[0]
    assert all(t.shape == x.shape and t.dtype == x.dtype for t in made)
    (fn, (src, dst, work, addr)), = calls
    assert fn == "fft4" and (src, dst, work) == (
        x.data_ptr(), made[0].data_ptr(), made[1].data_ptr())
    assert addr == F._launch4_args(-1, n, 3, False)[0]


@pytest.mark.parametrize("n", NS4)
def test_step_twiddles_are_rounded_roots_in_workspace_order(n):
    """Entry k1 N2 + n2 multiplies workspace element k1 N2 + n2: the root
    w_n^(n2 k1), computed in float64 and rounded to complex64 once."""
    n1, n2 = F.split(n)
    tw = F.step_twiddles(n)
    assert tw.dtype == np.complex64 and tw.shape == (n,)
    k1 = np.arange(n1)[:, None]
    c = np.arange(n2)[None, :]
    exact = np.exp(-2j * np.pi * ((k1 * c) % n) / n).ravel()
    np.testing.assert_array_equal(tw.real, exact.real.astype(np.float32))
    np.testing.assert_array_equal(tw.imag, exact.imag.astype(np.float32))
    assert np.max(np.abs(tw - exact)) < 2 ** -24


def _tile_addresses(n, first, load):
    """Element addresses within a row, in thread order, of one four-step
    block's copy of its TILE lines (csrc/fft.cu fft_four_step) -- for
    every block of a row: ``[(block, [(thread, k, address)])]``."""
    n1, n2 = F.split(n)
    length, lines = (n1, n2) if first else (n2, n1)
    threads = F.TILE * length // F.values(length)
    blocks = []
    for b in range(lines // F.TILE):
        col0 = b * F.TILE
        acc = []
        for k in range(F.values(length)):
            for tid in range(threads):
                idx = tid + k * threads
                if load and not first:  # a workspace row, contiguous
                    c, e = divmod(idx, length)
                    addr = (col0 + c) * length + e
                else:  # a column of the row seen as length x lines
                    c, e = idx % F.TILE, idx // F.TILE
                    addr = e * lines + col0 + c
                acc.append((tid, k, addr))
        blocks.append(acc)
    return blocks


@pytest.mark.parametrize("n", [2 ** 14, 2 ** 15])
@pytest.mark.parametrize("first", [True, False], ids=["pass1", "pass2"])
@pytest.mark.parametrize("load", [True, False], ids=["load", "store"])
def test_four_step_tiles_cover_a_row_once_in_whole_sectors(n, first, load):
    """A pass's blocks load and store every element of a row exactly
    once, and each warp's access touches only whole 32-byte sectors
    (runs of at least 4 adjacent complex64 values)."""
    blocks = _tile_addresses(n, first, load)
    every = [a for blk in blocks for _, _, a in blk]
    assert sorted(every) == list(range(n))
    for blk in blocks:
        by_warp = {}
        for tid, k, addr in blk:
            by_warp.setdefault((k, tid // 32), []).append(addr)
        for addrs in by_warp.values():
            sectors = {a // 4 for a in addrs}
            assert len(sectors) * 4 == len(addrs)  # no sector half used


@pytest.mark.parametrize("length", [128, 256, 512, 1024])
def test_four_step_exchange_has_no_bank_conflicts(length):
    """A four-step block runs TILE lines side by side through the same
    register passes and swizzled exchange as TILE rows of fft_rows."""
    assert _exchange_conflicts(length, F.TILE) == 1


def _four_step_model(x, inverse):
    """The four-step kernel's index arithmetic in numpy (each line's DFT
    by np.fft): pass 1 loads column n2 of the row seen as N1 x N2
    (conjugated for the inverse), multiplies element k1 of its DFT by the
    step twiddle at k1 N2 + n2 and stores it there in the workspace;
    pass 2 takes workspace row k1 and stores element k2 of its DFT at
    k1 + N1 k2 (conjugated and scaled for the inverse)."""
    rows, n = x.shape
    n1, n2 = F.split(n)
    tw = F.step_twiddles(n)
    out = np.empty_like(x)
    for r in range(rows):
        row = np.conj(x[r]) if inverse else x[r]
        work = np.empty(n, np.complex128)
        for col in range(n2):
            y = np.fft.fft(row[np.arange(n1) * n2 + col])
            at = np.arange(n1) * n2 + col
            work[at] = y * tw[at]
        for k1 in range(n1):
            z = np.fft.fft(work[k1 * n2:(k1 + 1) * n2])
            if inverse:
                z = np.conj(z) / n
            out[r, k1 + n1 * np.arange(n2)] = z
    return out


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [2 ** 14, 2 ** 15])
def test_four_step_index_model_is_the_dft(n, inverse):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(
        np.complex64)
    got = _four_step_model(x, inverse)
    want = np.fft.ifft(x) if inverse else np.fft.fft(x)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) < 1e-6 * scale


@pytest.mark.parametrize("n", [2 ** 14, 2 ** 15, 2 ** 20])
@pytest.mark.parametrize("inverse", [False, True])
def test_launch4_args_carry_the_plan(n, inverse):
    """The structure a four-step launch hands the kernel by address
    (``Fft4Launch`` of csrc/fft.cu: three pointers, one int64, two int32)
    holds the call's rows, N and direction, the pass tables of N1 and N2
    and the step table, and is built once per call shape."""
    import ctypes

    addr, args, (table, step) = F._launch4_args(-1, n, 3, inverse)
    assert ctypes.sizeof(args) == 40 and addr == ctypes.addressof(args)
    n1, n2 = F.split(n)
    ptrs = F.twiddle_tables("cpu")[1]
    assert (args.twiddles1, args.twiddles2) == (
        ptrs[n1.bit_length() - 1], ptrs[n2.bit_length() - 1])
    assert table is F.twiddle_tables("cpu")[0]
    assert step is F.step_table("cpu", n) and args.step == step.data_ptr()
    assert torch.equal(step, torch.from_numpy(F.step_twiddles(n)))
    assert (args.rows, args.n, args.inverse) == (3, n, int(inverse))
    assert F._launch4_args(-1, n, 3, inverse)[1] is args
