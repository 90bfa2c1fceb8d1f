"""The FFT kernel's host-side plan and the kernels' launch helper, on the CPU.

The CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); what the wrappers compute in Python before a
launch -- the twiddle table, the pass plan, the launch geometry, the
shared-memory layouts and their banks, the fused Bluestein route's launch
structure and index maps -- and the launch helper's device guard are
checked here.
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


def _degree(addrs):
    """Worst bank-conflict degree of one warp's 8-byte shared accesses:
    within a half-warp, distinct addresses that share a bank pair (index
    mod 16)."""
    out = 1
    for half in (addrs[:16], addrs[16:]):
        banks = {}
        for a in half:
            banks.setdefault(a % 16, set()).add(a)
        out = max([out] + [len(v) for v in banks.values()])
    return out


def _exchange_conflicts(n, rpg, slot=None):
    """Worst bank-conflict degree of the shared-memory exchanges of
    ``csrc/fft.cu`` for a block of ``rpg`` rows of ``n``: pass q of radix R
    over sub-length Ns writes y[(j / Ns) Ns R + j mod Ns + r Ns] and the
    next pass reads x[j + r n / R]; element e of row ``row`` is stored at
    ``slot(row, e)``, by default the rows' swizzle of row n + e
    (``F.swizzle``: g ^ ((g / V) mod 16), V values a thread)."""
    if slot is None:
        def slot(row, e):
            return F.swizzle(row * n + e, n)
    r_all = F.radices(n)
    values = F.values(n)
    per_row = n // values
    threads = rpg * per_row
    worst, ns = 1, 1
    for q, radix in enumerate(r_all):
        for i in range(values // radix):
            for r in range(radix):
                for w0 in range(0, threads, 32):
                    reads, writes = [], []
                    for tid in range(w0, min(w0 + 32, threads)):
                        row, t = divmod(tid, per_row)
                        j = t + i * per_row
                        src = j + r * (n // radix)
                        dst = (j // ns) * ns * radix + j % ns + r * ns
                        reads.append(slot(row, src))
                        writes.append(slot(row, dst))
                    if q > 0:
                        worst = max(worst, _degree(reads))
                    if q < len(r_all) - 1:
                        worst = max(worst, _degree(writes))
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
        tile = F.tile(length)
        return (tile * (length // F.values(length)),
                rows * (lines // tile), 2 * tile * length * 8)

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
    tile = F.tile(length)
    threads = tile * length // F.values(length)
    blocks = []
    for b in range(lines // tile):
        col0 = b * tile
        acc = []
        for k in range(F.values(length)):
            for tid in range(threads):
                idx = tid + k * threads
                if load and not first:  # a workspace row, contiguous
                    c, e = divmod(idx, length)
                    addr = (col0 + c) * length + e
                else:  # a column of the row seen as length x lines
                    c, e = idx % tile, idx // tile
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


def _tile_layout(length):
    """Where a four-step block stores element e of its line c."""
    def slot(c, e):
        return F.tile_slot(c, e, length)
    return slot


@pytest.mark.parametrize("length", [128, 256, 512, 1024])
def test_four_step_exchange_has_no_bank_conflicts(length):
    """A four-step block runs TILE lines side by side through the same
    register passes as TILE rows of fft_rows, its lines at
    ``F.tile_slot``: a line's XOR moves whole half-warps (a line has at
    least 16 threads), so the exchange stays free of conflicts."""
    assert _exchange_conflicts(length, F.TILE,
                               slot=_tile_layout(length)) == 1


def _tile_copy_conflicts(length, first, load, slot):
    """Worst bank-conflict degree of a four-step block's copies between
    device and shared memory (csrc/fft.cu fft_four_step) over lines of
    ``length``: value k of thread tid is idx = tid + k THREADS; pass 1's
    loads and both passes' stores take line c = idx mod TILE, element e =
    idx / TILE (a run of TILE adjacent columns or outputs in device
    memory), pass 2's loads line c = idx / length, element e = idx mod
    length (a workspace row); element e of line c sits at ``slot(c, e)``."""
    tile = F.tile(length)
    threads = tile * length // F.values(length)
    worst = 1
    for k in range(F.values(length)):
        for w0 in range(0, threads, 32):
            addrs = []
            for tid in range(w0, w0 + 32):
                idx = tid + k * threads
                if load and not first:
                    c, e = divmod(idx, length)
                else:
                    e, c = divmod(idx, tile)
                addrs.append(slot(c, e))
            worst = max(worst, _degree(addrs))
    return worst


@pytest.mark.parametrize("length", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("first", [True, False], ids=["pass1", "pass2"])
@pytest.mark.parametrize("load", [True, False], ids=["load", "store"])
def test_four_step_tile_copies_have_no_bank_conflicts(length, first, load):
    """Every half-warp of every tile copy, global to shared and shared to
    global, lands in 16 distinct bank pairs (TILE 8 up to lines of 1024,
    4 at 2048)."""
    assert _tile_copy_conflicts(length, first, load,
                                _tile_layout(length)) == 1


@pytest.mark.parametrize("length", [128, 256, 512, 1024, 2048])
def test_rows_swizzle_alone_conflicts_on_the_strided_tile_copies(length):
    """The walk sees the conflicts the line XOR removes: with the rows'
    swizzle alone a strided copy's half-warp puts all TILE lines' element
    at one bank pair (TILE-way), a workspace row's contiguous copy has
    none."""
    def rows_only(c, e):
        return F.swizzle(c * length + e, length)

    assert _tile_copy_conflicts(length, True, True,
                                rows_only) == F.tile(length)
    assert _tile_copy_conflicts(length, False, True, rows_only) == 1


def test_tile_slot_is_a_permutation_of_the_tile():
    """The tile layout stores each of a block's TILE x length values at
    its own place, inside the block's buffer."""
    for length in (128, 256, 512, 1024, 2048):
        tile = F.tile(length)
        slots = {F.tile_slot(c, e, length)
                 for c in range(tile) for e in range(length)}
        assert slots == set(range(tile * length))


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


# ------------------------------------------- 2^21: Bluestein's inner length
def test_the_kernel_takes_bluestein_inner_length():
    """N above 2^19 needs inner transforms of 2^21: N1 x N2 = 2048 x 1024,
    pass 1's lines of 2048 four to a block (512 threads, 128 KB of
    exchange buffers), pass 2's eight."""
    n = F.MAX_POW2
    assert n == 2 ** 21
    assert F.split(n) == (2048, 1024)
    assert (F.tile(2048), F.tile(1024), F.tile(128)) == (4, 8, 8)
    assert len(F.radices(2048)) >= 2
    for rows in ROWS + (2 ** 10,):
        for threads, grid, smem in _four_step_geometry(n, rows):
            assert 1 <= threads <= KERNEL_MAX_THREADS
            assert 1 <= grid <= MAX_GRID_X
            assert smem <= MAX_SMEM


@pytest.mark.parametrize("first", [True, False], ids=["pass1", "pass2"])
@pytest.mark.parametrize("load", [True, False], ids=["load", "store"])
def test_four_step_tiles_at_2_21_cover_a_row_in_whole_sectors(first, load):
    blocks = _tile_addresses(F.MAX_POW2, first, load)
    every = [a for blk in blocks for _, _, a in blk]
    assert sorted(every) == list(range(F.MAX_POW2))
    for blk in blocks[:64]:
        by_warp = {}
        for tid, k, addr in blk:
            by_warp.setdefault((k, tid // 32), []).append(addr)
        for addrs in by_warp.values():
            sectors = {a // 4 for a in addrs}
            assert len(sectors) * 4 == len(addrs)


def test_four_step_exchange_of_four_lines_of_2048_has_no_conflicts():
    assert _exchange_conflicts(2048, F.tile(2048),
                               slot=_tile_layout(2048)) == 1


def test_launch4_args_at_2_21():
    addr, args, (table, step) = F._launch4_args(-1, F.MAX_POW2, 1, True)
    ptrs = F.twiddle_tables("cpu")[1]
    assert (args.twiddles1, args.twiddles2) == (ptrs[11], ptrs[10])
    assert step.shape == (F.MAX_POW2,) and args.n == F.MAX_POW2


# ------------------------------------------- Bluestein in one C entry
#: lengths past one launch of the FFT that Bluestein takes in one launch
#: (M <= 8192) and in four four-step launches (M above)
BLUESTEIN_ONE = (3, 12, 1000, 1536, 3000, 4095)
BLUESTEIN_FOUR = (5000, 12289, 100000, (1 << 20) - 1)


def _bluestein_model(x, inverse):
    """The fused Bluestein route's index maps (csrc/fft.cu bluestein_rows
    and fft_four_step's Bluestein edges) in numpy, each line's DFT by
    np.fft in complex128 over the complex64 tables: the predicated load of
    x w (zeros from N on), the forward transform, the spectrum's product
    at each natural index and the conjugation as the inverse reads it,
    the inverse transform, and the store of the conjugate / M times w for
    the first N elements only."""
    from repro_torch.kernels.fft import bluestein as BL

    rows, n = x.shape
    m = BL.inner_length(n)
    w, spec = (t.numpy().astype(np.complex128)
               for t in BL.tables(n, inverse, "cpu"))
    out = np.full((rows, n), np.nan, np.complex128)
    for row in range(rows):
        if m <= F.TABLE_N:
            # thread t's first pass holds elements t + r M / V, r < V
            v = F.values(m)
            t = np.arange(m // v)[:, None]
            at = (t + np.arange(v)[None, :] * (m // v)).ravel()
            assert sorted(at) == list(range(m))
            a = np.zeros(m, np.complex128)
            keep = at < n
            a[at[keep]] = x[row, at[keep]] * w[at[keep]]
            y = np.fft.fft(a)
            b = np.conj(y[at] * spec[at])  # the inverse's first read
            z = np.empty(m, np.complex128)
            z[at] = b
            z = np.fft.fft(z)
            # the last pass of radix R: thread t's butterfly i stores
            # j + r M / R, j = t + i T < M / R
            radix = F.radices(m)[-1]
            j = np.arange(m // radix)[:, None]
            put = (j + np.arange(radix)[None, :] * (m // radix)).ravel()
            assert sorted(put) == list(range(m))
            put = put[put < n]
            out[row, put] = np.conj(z[put]) / m * w[put]
            continue
        m1, m2 = F.split(m)
        step = F.step_twiddles(m).astype(np.complex128)

        def four_step(load, store):
            work = np.empty(m, np.complex128)
            for col in range(m2):  # pass 1: column col, element e at e M2
                at = np.arange(m1) * m2 + col
                work[at] = np.fft.fft(load(at)) * step[at]
            for k1 in range(m1):  # pass 2: workspace row k1
                store(k1 + m1 * np.arange(m2),
                      np.fft.fft(work[k1 * m2:(k1 + 1) * m2]))

        def load_chirp(at):
            a = np.zeros(len(at), np.complex128)
            keep = at < n
            a[keep] = x[row, at[keep]] * w[at[keep]]
            return a

        fwd = np.empty(m, np.complex128)

        def store_fwd(at, y):
            fwd[at] = y

        def store_chirp(at, y):
            keep = at < n
            out[row, at[keep]] = np.conj(y[keep]) / m * w[at[keep]]

        four_step(load_chirp, store_fwd)
        four_step(lambda at: np.conj(fwd[at] * spec[at]), store_chirp)
    assert not np.isnan(out).any()  # every element stored once at least
    return out


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [1000, 4095, 5000, 12289])
def test_bluestein_index_model_is_the_dft(n, inverse):
    """The fused route's index maps compute numpy's DFT: in one launch at
    1000 and 4095 (M 2048, 8192), in four launches at 5000 and 12289 (M
    16384, 32768)."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(
        np.complex64)
    got = _bluestein_model(x, inverse)
    want = np.fft.ifft(x) if inverse else np.fft.fft(x)
    # the tables are complex64: about 2^-24 of the largest value, grown by
    # the two transforms' sums
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("n", BLUESTEIN_ONE)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("block_rows", [8, 32, 128])
def test_bluestein_one_launch_geometry_within_card_limits(n, rows,
                                                          block_rows):
    """Up to M = 8192 the one launch takes the FFT's launch_plan of M (so
    block_rows keeps its meaning) with two shared buffers a group even
    for one pass, within the card's limits and the kernel's bound."""
    from repro_torch.kernels.fft import bluestein as BL

    m = BL.inner_length(n)
    threads, rpg, gpb, grid, smem = BL.launch_geometry(n, rows, block_rows)
    assert (threads, rpg, gpb, grid) == F.launch_plan(m, rows,
                                                      block_rows)[:4]
    assert smem == 2 * rpg * m * 8 <= MAX_SMEM
    assert 1 <= threads <= KERNEL_MAX_THREADS
    assert grid * gpb * rpg >= rows > (grid - 1) * gpb * rpg
    assert 1 <= grid <= MAX_GRID_X


@pytest.mark.parametrize("n", BLUESTEIN_FOUR)
def test_bluestein_above_8192_takes_the_four_step_geometry(n):
    """Above M = 8192 there is no one-launch geometry: the four launches
    take the four-step's of M, which fits the card at every row count."""
    from repro_torch.kernels.fft import bluestein as BL

    m = BL.inner_length(n)
    assert m > F.TABLE_N and BL.launch_geometry(n, 3, 8) is None
    for rows in ROWS:
        for threads, grid, smem in _four_step_geometry(m, rows):
            assert 1 <= threads <= KERNEL_MAX_THREADS
            assert 1 <= grid <= MAX_GRID_X
            assert smem <= MAX_SMEM


@pytest.mark.parametrize("n", [3, 1000, 4095, 5000, 12289])
@pytest.mark.parametrize("inverse", [False, True])
def test_bluestein_launch_args_carry_the_plan(n, inverse):
    """The structure a Bluestein call hands ``rimms_bluestein_c64`` by
    address (``BluesteinLaunch`` of csrc/fft.cu: five pointers, two int64,
    six int32) holds the call's rows, N, M and geometry, the chirp and
    spectrum of (N, direction), M's pass table (M1's, M2's and the step
    table above 8192), and is built once per call shape."""
    import ctypes

    from repro_torch.kernels.fft import bluestein as BL

    m = BL.inner_length(n)
    addr, args, keep = BL._launch_args(-1, n, 3, 32, inverse)
    assert ctypes.sizeof(args) == 80 and addr == ctypes.addressof(args)
    w, spec = BL.tables(n, inverse, "cpu")
    assert (args.chirp, args.spectrum) == (w.data_ptr(), spec.data_ptr())
    assert any(t is w for t in keep) and any(t is spec for t in keep)
    assert (args.rows, args.n, args.m) == (3, n, m)
    table, ptrs = F.twiddle_tables("cpu")
    assert keep[0] is table
    geometry = (args.threads, args.rows_per_group, args.groups_per_block,
                args.grid, args.smem)
    if m <= F.TABLE_N:
        assert args.twiddles1 == ptrs[m.bit_length() - 1]
        assert args.twiddles2 is None and args.step is None
        assert geometry == BL.launch_geometry(n, 3, 32)
    else:
        m1, m2 = F.split(m)
        assert (args.twiddles1, args.twiddles2) == (
            ptrs[m1.bit_length() - 1], ptrs[m2.bit_length() - 1])
        step = F.step_table("cpu", m)
        assert args.step == step.data_ptr() and any(t is step for t in keep)
        assert geometry == (0, 0, 0, 0, 0)
    assert BL._launch_args(-1, n, 3, 32, inverse)[1] is args
