"""The RG-LRU and mLSTM kernels' host-side plans and index maps, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).  Here numpy models of their loops -- which thread
writes which element, which pass reads what, the order of the RG-LRU's
rounded operations, the mLSTM's fragment layouts and split-TF32 operands
-- are walked over many shapes, ragged ones included, and held against
the plain torch versions the kernels are compared with on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.mlstm import mlstm as ML
from repro_torch.kernels.rg_lru import rg_lru as RL

torch.set_num_threads(1)

#: shared memory a block can opt in to on the H100, less the 1 KB the
#: kernels keep in reserve
SMEM_LIMIT = 232448 - 1024


# ------------------------------------------------------------- RG-LRU ----
RG_PLANS = [(1, 1, 128, 128), (2, 63, 200, 128), (1, 64, 256, 256),
            (3, 65, 130, 128), (1, 200, 384, 256), (2, 257, 512, 512),
            (1, 0, 128, 128)]


@pytest.mark.parametrize("B,S,D,lanes", RG_PLANS)
def test_rg_lru_every_step_and_lane_written_once(B, S, D, lanes):
    """Pass 2 writes each (t, lane) of h_seq once and h_final once a lane;
    pass 1 writes one summary for every chunk but the last, and pass 2's
    chunk k reads the summaries of chunks 0..k-1 only."""
    plan = RL.launch_plan(B, S, D, lanes)
    L, threads = RL.CHUNK, plan["threads"]
    assert plan["chunks"] == max(-(-S // L), 1)
    assert threads <= RL.MAX_THREADS
    writes = np.zeros((B, S, D), np.int64)
    final = np.zeros((B, D), np.int64)
    sums = np.zeros(plan["sums_shape"][:3], np.int64)
    tiles, nsum, _ = plan["summary_grid"]
    for b in range(B):
        for x in range(tiles):
            first, last = x * lanes, min(x * lanes + lanes, D)
            for tid in range(threads):
                ln = np.arange(first + tid, last, threads)
                for k in range(nsum):
                    sums[b, k, ln] += 1
                for k in range(plan["scan_grid"][1]):
                    assert k - 1 < nsum  # reads summaries 0..k-1 only
                    t0 = k * L
                    for t in range(t0, min(t0 + L, S)):
                        writes[b, t, ln] += 1
                    if k == plan["scan_grid"][1] - 1:
                        final[b, ln] += 1
    assert (writes == 1).all() and (final == 1).all() and (sums == 1).all()


def _rg_lru_model(a, b, h0):
    """The kernel's arithmetic in numpy float32, loop for loop: summaries
    from h = 0, the carry walk, the scan from the carried state."""
    B, S, D = a.shape
    L = RL.CHUNK
    nc = max(-(-S // L), 1)
    p = np.ones((B, nc - 1, D), np.float32)
    hl = np.zeros((B, nc - 1, D), np.float32)
    for k in range(nc - 1):
        for t in range(k * L, k * L + L):
            hl[:, k] = a[:, t] * hl[:, k] + b[:, t]
            p[:, k] = p[:, k] * a[:, t]
    hs = np.empty_like(a)
    hn = h0.copy()
    for k in range(nc):
        h = h0.copy()
        for j in range(k):
            h = p[:, j] * h + hl[:, j]
        for t in range(k * L, min(k * L + L, S)):
            h = a[:, t] * h + b[:, t]
            hs[:, t] = h
        hn = h
    return hs, hn


@pytest.mark.parametrize("S", [1, 40, 64, 65, 128, 150, 257])
def test_rg_lru_plain_is_the_kernels_arithmetic(S):
    """rg_lru_plain rounds every product and sum where the kernel does,
    in the same order: bit for bit the numpy model of the kernel's
    loops."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.3, 0.999, (2, S, 136)).astype(np.float32)
    b = rng.normal(size=(2, S, 136)).astype(np.float32)
    h0 = rng.normal(size=(2, 136)).astype(np.float32)
    ws, wn = _rg_lru_model(a, b, h0)
    hs, hn = RL.rg_lru_plain(*(torch.from_numpy(x) for x in (a, b, h0)))
    np.testing.assert_array_equal(hs.numpy(), ws)
    np.testing.assert_array_equal(hn.numpy(), wn)


def test_rg_lru_one_chunk_is_the_sequential_loop():
    """A sequence of at most CHUNK steps is one chunk: the plain scan is
    then the sequential loop, bit for bit."""
    rng = np.random.default_rng(0)
    S = RL.CHUNK
    a = rng.uniform(0.3, 0.999, (3, S, 128)).astype(np.float32)
    b = rng.normal(size=(3, S, 128)).astype(np.float32)
    h = rng.normal(size=(3, 128)).astype(np.float32)
    hs, hn = RL.rg_lru_plain(*(torch.from_numpy(x) for x in (a, b, h)))
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_array_equal(hs[:, t].numpy(), h)
    np.testing.assert_array_equal(hn.numpy(), h)


# -------------------------------------------------------------- mLSTM ----
#: (B, S, H, m, chunk): the reference's sweep, ragged widths and chunks,
#: the two timed shapes and the contract's largest
ML_PLANS = [(2, 64, 2, 128, 16), (1, 32, 4, 64, 8), (1, 128, 1, 128, 64),
            (1, 48, 3, 24, 24), (1, 96, 1, 33, 32), (1, 40, 1, 8, 40),
            (1, 256, 2, 72, 128), (1, 4096, 4, 512, 64),
            (1, 5376, 2, 64, 64), (1, 256, 1, 1024, 128)]


@pytest.mark.parametrize("B,S,H,m,c", ML_PLANS)
def test_mlstm_plan_fits_the_card(B, S, H, m, c):
    plan = ML.launch_plan(B, S, H, m, c)
    assert plan["intra_smem"] <= SMEM_LIMIT
    assert plan["inter_smem"] <= SMEM_LIMIT
    assert plan["cp"] % 16 == 0 and c <= plan["cp"] < c + 16
    assert plan["intra_grid"] == (S // c, B * H)
    assert plan["inter_grid"] == (-(-m // ML.COLS), B * H)
    # a chunk takes at least two steps, so the update of a slice (one
    # step after its q C) lands before the next chunk's q C reads it
    nz = plan["steps"]
    assert nz >= 2 and nz >= plan["m_slices"]
    for j in range(2):
        for z in range(plan["m_slices"]):
            assert j * nz + z + 1 < (j + 1) * nz + z
    assert plan["work"] == B * S * H * m + B * H * (S // c) * (3 * c + 1)


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3


@pytest.mark.parametrize("B,S,H,m,c", ML_PLANS[:7])
def test_mlstm_every_output_and_column_of_c_covered_once(B, S, H, m, c):
    """Pass 2: warps 4-7 write each (row, column) of a chunk's h once
    (row tiles w and w + 4, both column tiles); warps 0-3 update each
    (row, column) of the block's 16 columns of C once a slice, and lanes
    p = 0 each column of n once; every column of C has one block.  Pass
    1: warp w owns A's rows 16w..16w+15, and A V's (row, column) are
    written once a slice of v."""
    plan = ML.launch_plan(B, S, H, m, c)
    cp, nm = plan["cp"], plan["m_slices"]
    g, t4 = _lanes()
    out = np.zeros((c, m), np.int64)
    ccov = np.zeros((nm * ML.SLICE, plan["inter_grid"][0] * ML.COLS),
                    np.int64)
    ncov = np.zeros(nm * ML.SLICE, np.int64)
    for bx in range(plan["inter_grid"][0]):
        e0 = bx * ML.COLS
        for w4 in range(4):
            for u in range(4):
                rt, nt = w4 + 4 * (u >> 1), u & 1
                if rt >= cp // 16:
                    continue
                for e in range(4):
                    t = 16 * rt + g + 8 * (e >> 1)
                    col = e0 + 8 * nt + 2 * t4 + (e & 1)
                    ok = (t < c) & (col < m)
                    np.add.at(out, (t[ok], col[ok]), 1)
        for z in range(nm):
            for warp in range(4):
                rt, nt = warp >> 1, warp & 1
                for e in range(4):
                    row = z * ML.SLICE + 16 * rt + g + 8 * (e >> 1)
                    col = e0 + 8 * nt + 2 * t4 + (e & 1)
                    np.add.at(ccov, (row, col), 1)
                lane = np.arange(32)
                p0 = (lane >> 3) == 0
                if bx == 0:
                    np.add.at(ncov, z * ML.SLICE + 8 * warp + (lane & 7)[p0],
                              1)
    assert (out == 1).all()
    assert (ccov == 1).all() and (ncov == 1).all()
    # pass 1: A's rows by warp, A V's entries by v slice
    rows = np.concatenate([16 * w + np.arange(16) for w in range(8)
                           if 16 * w < cp])
    np.testing.assert_array_equal(np.sort(rows), np.arange(cp))
    av = np.zeros((c, m), np.int64)
    for sl in range(nm):
        for w in range(8):
            if 16 * w >= cp:
                continue
            for nt in range(ML.SLICE // 8):
                for e in range(4):
                    t = 16 * w + g + 8 * (e >> 1)
                    i = sl * ML.SLICE + 8 * nt + 2 * t4 + (e & 1)
                    ok = (t < c) & (i < m)
                    np.add.at(av, (t[ok], i[ok]), 1)
    assert (av == 1).all()


@pytest.mark.parametrize("B,S,H,m,c", ML_PLANS[:7])
def test_mlstm_state_has_every_update_and_is_written_once(B, S, H, m, c):
    """With ``return_state``, pass 2 applies each (chunk, slice) of the C
    and n update once, in chunk order: a step's slice one step later in
    the loop, the last step's after it; then each (a, e) of C is written
    by the block of e's 16 columns, once, and n once, by column tile 0."""
    plan = ML.launch_plan(B, S, H, m, c)
    nm, nz = plan["m_slices"], plan["steps"]
    nsteps = plan["chunks"] * nz
    applied = [st - 1 for st in range(1, nsteps) if (st - 1) % nz < nm]
    if (nsteps - 1) % nz < nm:
        applied.append(nsteps - 1)  # after the loop
    assert applied == [j * nz + z for j in range(plan["chunks"])
                       for z in range(nm)]
    ccov = np.zeros((m, m), np.int64)
    ncov = np.zeros(m, np.int64)
    for bx in range(plan["inter_grid"][0]):
        e0 = bx * ML.COLS
        for tid in range(ML.THREADS):
            for e in range(tid, ML.COLS * m, ML.THREADS):
                a, col = e // ML.COLS, e % ML.COLS
                if e0 + col < m:
                    ccov[a, e0 + col] += 1
            if bx == 0:
                ncov[tid:m:ML.THREADS] += 1
    assert (ccov == 1).all() and (ncov == 1).all()


def _mma_m16n8k8(afrag, bfrag):
    """What mma.m16n8k8 computes from per-lane fragments: A's element
    (row, slot) is lane 4 (row % 8) + slot % 4, register (row >= 8) +
    2 (slot >= 4); B's (slot, col) is lane 4 col + slot % 4, register
    slot >= 4."""
    a = np.zeros((16, 8))
    b = np.zeros((8, 8))
    for r in range(16):
        for s in range(8):
            a[r, s] = afrag[4 * (r % 8) + s % 4][(r >= 8) + 2 * (s >= 4)]
    for s in range(8):
        for n in range(8):
            b[s, n] = bfrag[4 * n + s % 4][s >= 4]
    return a @ b


def test_mlstm_fragments_with_adjacent_k_compute_the_product():
    """The kernels feed k = 2 t4 and 2 t4 + 1 into a lane's k slots t4
    and t4 + 4, in A and B alike: the product is A B all the same."""
    rng = np.random.default_rng(3)
    A = rng.integers(-8, 8, (16, 8)).astype(np.float64)
    Bm = rng.integers(-8, 8, (8, 8)).astype(np.float64)
    afrag, bfrag = [], []
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        afrag.append([A[g, 2 * t4], A[g + 8, 2 * t4], A[g, 2 * t4 + 1],
                      A[g + 8, 2 * t4 + 1]])
        bfrag.append([Bm[2 * t4, g], Bm[2 * t4 + 1, g]])
    np.testing.assert_array_equal(_mma_m16n8k8(afrag, bfrag), A @ Bm)


def _tf32(x):
    """What the tensor cores read of a float32 TF32 operand: its top 19
    bits."""
    return (np.asarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def test_mlstm_split_tf32_products_keep_float32_accuracy():
    """x = hi + lo with hi cut to TF32 and lo = x - hi exact: the three
    TF32 products hi hi + (lo hi + hi lo) are within 2^-18 of a b (each
    cut lo is within 2^-20 of x, and lo lo is left out), where a single
    TF32 product is off by up to 2^-9."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=100000).astype(np.float32)
    b = rng.normal(size=100000).astype(np.float32)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = a - ah, b - bh
    assert (ah + al == a).all() and (bh + bl == b).all()  # exact split
    exact = a.astype(np.float64) * b
    split = (ah.astype(np.float64) * bh + _tf32(al).astype(np.float64) * bh
             + ah.astype(np.float64) * _tf32(bl))
    rel = np.abs(split - exact) / np.abs(exact)
    assert rel.max() < 2.0 ** -18
    plain = ah.astype(np.float64) * bh
    assert (np.abs(plain - exact) / np.abs(exact)).max() > 2.0 ** -12
