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


# ------------------------------------------------------ mLSTM backward ----
#: (B, S, H, m, chunk): chunks 16/48/64/128 at ragged and full widths
#: (m 40/96/200/512/1024), four chunks or one (S = chunk)
BWD_PLANS = ([(1, 4 * c, 2, m, c) for c in (16, 48, 64, 128)
              for m in (40, 96, 200, 512, 1024)]
             + [(1, c, 1, m, c) for c in (16, 48, 64, 128) for m in (40, 96)])
#: the SM's shared memory, which two blocks of the grads kernel share
#: when its warps own 4 column tiles or fewer
SM_SMEM = 233472


@pytest.mark.parametrize("B,S,H,m,c", BWD_PLANS)
def test_mlstm_backward_plan_fits_the_card(B, S, H, m, c):
    """Each kernel's shared memory fits a block (and two grads blocks an
    SM when nt <= 4); the grads kernel's warp tasks fit its 8 warps and
    cover its row tiles; the grids and workspace follow the shape."""
    plan = ML.backward_plan(B, S, H, m, c)
    for key in ("state_smem", "scores_smem", "grads_smem"):
        assert plan[key] <= SMEM_LIMIT, key
    if plan["nt"] <= 4:
        assert 2 * (plan["grads_smem"] + 1024) <= SM_SMEM
    cp, nrt, nt = plan["cp"], plan["row_tiles"], plan["nt"]
    assert cp % 16 == 0 and c <= cp < c + 16 and nrt == cp // 16
    assert nt in (1, 2, 4, 8) and plan["col_groups"] * nt == 8
    assert nrt <= plan["tasks"] <= 8 and plan["tasks"] % nrt == 0
    nc, ct = S // c, -(-m // ML.BWD_COLS)
    assert plan["grads_grid"] == (nc * ct, B * H)
    assert plan["state_grid"] == (ct * ct, B * H)
    assert plan["grads_steps"] == -(-m // ML.BWD_DEPTH) + cp // ML.BWD_DEPTH
    assert plan["state_steps"] == (nc - 1) * -(-c // ML.BWD_TOK)
    assert plan["work"] == ML.backward_work(B, S, H, m, c)


def _grads_tasks(plan):
    """(row tile, first column within the 64, nt) of each active warp."""
    ngr = plan["col_groups"]
    return [(w // ngr, 8 * plan["nt"] * (w % ngr), plan["nt"])
            for w in range(plan["tasks"])]


@pytest.mark.parametrize("B,S,H,m,c", BWD_PLANS)
def test_mlstm_backward_every_gradient_and_share_written_once(B, S, H, m, c):
    """The grads kernel: over the blocks of a chunk (64 columns each)
    and their warps' fragments (rows g, g + 8, columns 2 t4, 2 t4 + 1 of
    each column tile), every (token, column) of dq, dk and dv is written
    once; each block's row shares are reduced through ``red`` written
    once a (column group, row) by lanes t4 = 0, and each share of the
    gates (q~ . Z and k . Y per token, dC : C_in per block) is written
    once."""
    plan = ML.backward_plan(B, S, H, m, c)
    cp, ct = plan["cp"], plan["col_tiles"]
    g, t4 = _lanes()
    out = np.zeros((c, m), np.int64)
    parts = np.zeros((ct, 2 * c + 1), np.int64)
    for pt in range(ct):
        a0 = pt * ML.BWD_COLS
        red = np.zeros((plan["col_groups"], cp), np.int64)
        for rt, n0, nt_ in _grads_tasks(plan):
            for nt in range(nt_):
                for h in range(2):
                    t = 16 * rt + g + 8 * h
                    a = a0 + n0 + 8 * nt + 2 * t4
                    for d in range(2):  # the pair's two columns
                        ok = (t < c) & (a + d < m)
                        np.add.at(out, (t[ok], a[ok] + d), 1)
            for h in range(2):
                rows = 16 * rt + g + 8 * h
                np.add.at(red, (n0 // (8 * nt_), rows[t4 == 0]), 1)
        assert (red == 1).all()
        parts[pt, :c] += 1        # threads tid < c: q~ . Z
        parts[pt, c:2 * c] += 1   # and k . Y
        parts[pt, 2 * c] += 1     # thread 0: dC : C_in + dn . n_in
    assert (out == 1).all()
    assert (parts == 1).all()


@pytest.mark.parametrize("B,S,H,m,c", BWD_PLANS)
def test_mlstm_backward_state_slots_written_once(B, S, H, m, c):
    """The state kernel: each chunk's slot is written once, the seed's
    (slot nc - 1) before the walk and slot j - 1 after chunk j's last
    token slice; the walk's steps go chunk nc - 1 down to 1 through the
    ring's stages in turn; a tile is staged by its warps' fragments and
    written by rows, each (a, e) of the m x m state once, and dn's rows
    once, by the first column tile's quads."""
    plan = ML.backward_plan(B, S, H, m, c)
    nc, nsc = S // c, -(-c // ML.BWD_TOK)
    written = [nc - 1]
    j, z, rb = nc - 1, 0, 0
    for st in range(plan["state_steps"]):
        assert (j, z, rb) == (nc - 1 - st // nsc, st % nsc,
                              st % ML.STATE_STAGES)
        if z == nsc - 1:
            written.append(j - 1)
        z += 1
        if z == nsc:
            z, j = 0, j - 1
        rb = (rb + 1) % ML.STATE_STAGES
    assert sorted(written) == list(range(nc))
    g, t4 = _lanes()
    tile = np.zeros((ML.BWD_COLS, ML.BWD_COLS), np.int64)
    for w in range(8):
        rt, cg = w >> 1, w & 1
        for nt in range(4):
            for h in range(2):
                for d in range(2):
                    np.add.at(tile, (16 * rt + g + 8 * h,
                                     32 * cg + 8 * nt + 2 * t4 + d), 1)
    assert (tile == 1).all()
    ct = plan["col_tiles"]
    for v in (4, 1):
        per_row = ML.BWD_COLS // v
        cov = np.zeros((m, m), np.int64)
        ncov = np.zeros(m, np.int64)
        for bx in range(plan["state_grid"][0]):
            a0, e0 = (bx // ct) * ML.BWD_COLS, (bx % ct) * ML.BWD_COLS
            for u in range(ML.BWD_COLS * per_row // ML.THREADS):
                e = np.arange(ML.THREADS) + u * ML.THREADS
                r, col = e // per_row, (e % per_row) * v
                ok = (a0 + r < m) & (e0 + col < m)
                for d in range(v):
                    np.add.at(cov, (a0 + r[ok], e0 + col[ok] + d), 1)
            if e0 == 0:
                tid = np.arange(ML.THREADS)
                na = a0 + (tid >> 2)
                ok = ((tid & 3) == 0) & (na < m)
                np.add.at(ncov, na[ok], 1)
        if m % 4 == 0 or v == 1:
            assert (cov == 1).all() and (ncov == 1).all()


@pytest.mark.parametrize("B,S,H,m,c", BWD_PLANS)
def test_mlstm_backward_scores_tiles_cover_each_matrix_once(B, S, H, m, c):
    """The scores kernel: the (chunk, tile pair) blocks, each 64 x 64 of
    t and s, write every entry of the cp x cp matrices A^T, dS, dS^T and
    dA S D once: blocks above the diagonal zeros by a loop over their
    tile, the others by their warps' fragments (rows 16 (w / 2), columns
    32 (w % 2)); below the diagonal tile only the column tiles that reach
    it hold products."""
    plan = ML.backward_plan(B, S, H, m, c)
    cp = plan["cp"]
    nt64 = -(-cp // ML.BWD_COLS)
    assert plan["scores_grid"] == (S // c * nt64 * nt64, B * H)
    g, t4 = _lanes()
    cov = np.zeros((cp, cp), np.int64)    # (t, s); the transposed planes
    for pair in range(nt64 * nt64):       # write (s, t) of the same pairs
        ti, si = pair // nt64, pair % nt64
        tb, sb = ti * ML.BWD_COLS, si * ML.BWD_COLS
        if si > ti:
            t, s = np.meshgrid(tb + np.arange(64), sb + np.arange(64),
                               indexing="ij")
            ok = (t < cp) & (s < cp)
            np.add.at(cov, (t[ok], s[ok]), 1)
            assert (s[ok] > t[ok]).all()
            continue
        for w in range(8):
            rt, cg = w >> 1, w & 1
            r0 = tb + 16 * rt
            if r0 >= cp:
                continue
            ntl = max(0, min(4, 2 * rt + 2 - 4 * cg)) if ti == si else 4
            for nt in range(4):
                for e in range(4):
                    t = r0 + g + 8 * (e >> 1)
                    s = sb + 32 * cg + 8 * nt + 2 * t4 + (e & 1)
                    ok = (t < cp) & (s < cp)
                    np.add.at(cov, (t[ok], s[ok]), 1)
                    if nt >= ntl:  # skipped products: all above it
                        assert (s > t).all()
    assert (cov == 1).all()


@pytest.mark.parametrize("v,w,nrows", [(4, 16, 16), (4, 16, 48), (4, 16, 64),
                                       (4, 16, 128), (4, 64, 16),
                                       (4, 64, 32), (1, 16, 80),
                                       (1, 64, 16), (1, 64, 32)])
def test_mlstm_backward_copies_cover_each_tile_once(v, w, nrows):
    """``stage_rows``: thread tid copies V floats at column (tid % (W /
    V)) V of rows tid / (W / V) + k kThreads / (W / V): every element of
    an nrows x W tile once."""
    per_row = w // v
    step = ML.THREADS // per_row
    cov = np.zeros((nrows, w), np.int64)
    for tid in range(ML.THREADS):
        i = (tid % per_row) * v
        for r in range(tid // per_row, nrows, step):
            cov[r, i:i + v] += 1
    assert (cov == 1).all()


@pytest.mark.parametrize("c", [16, 48, 64, 80, 128])
def test_mlstm_backward_skipped_steps_hold_only_zeros(c):
    """The grads kernel's intra products skip an 8-deep step of a warp's
    16 rows where the masked matrix is zero throughout: dS[t][s] (dq) for
    s > every t, dS^T and A^T (dk, dv) for t < every s; what it keeps
    covers every nonzero of the triangle once."""
    cp = -(-c // 16) * 16
    mask = np.tril(np.ones((cp, cp), bool))    # [t][s], s <= t
    used_q = np.zeros((cp, cp), np.int64)
    used_k = np.zeros((cp, cp), np.int64)
    for r0 in range(0, cp, 16):
        for kg in range(0, cp, 8):
            rows, ks = slice(r0, r0 + 16), slice(kg, kg + 8)
            lower = kg <= r0 + 15
            upper = kg + 7 >= r0
            if lower:
                used_q[rows, ks] += 1
            else:
                assert not mask[rows, ks].any()
            if upper:
                used_k[rows, ks] += 1
            else:   # rows s, columns t of the transposed: t >= s needed
                assert not mask.T[rows, ks].any()
    assert (used_q[mask] == 1).all() and (used_k[mask.T] == 1).all()


def test_mlstm_backward_ring_reuses_a_stage_after_reading_it():
    """A ring of n stages: step st is read from stage st % n at iteration
    st; the copy of step st + n - 1 goes, after that iteration's barrier,
    into the stage iteration st - 1 read, so no stage is refilled before
    its step is read (two stages and up)."""
    for n in (2, 3, 4):
        read_at = {}
        for st in range(40):
            read_at[st] = st
            nxt = st + n - 1
            stage = nxt % n
            assert stage == (st - 1) % n
            prev = nxt - n  # the step that stage held
            assert prev < 0 or read_at[prev] < st


# ------------------------------------------- mLSTM above a chunk of 128 ----
#: (B, S, H, m, chunk) past 128: the reference's 256 at xLSTM's width and
#: at the largest m, and chunks that are not multiples of 128 or of 16
ML_BIG = [(1, 4096, 4, 512, 256), (1, 512, 1, 1024, 256),
          (1, 384, 2, 72, 192), (1, 400, 1, 40, 200), (2, 512, 2, 64, 256)]


@pytest.mark.parametrize("B,S,H,m,c", ML_BIG)
def test_mlstm_plan_above_128_fits_the_card(B, S, H, m, c):
    """The instance for chunks above 128: slices of 16 in the second pass
    (its rings of a chunk's rows), four row tiles a warp, and the first
    pass's row blocks of 128 -- every pass within a block's shared
    memory."""
    plan = ML.launch_plan(B, S, H, m, c)
    assert plan["cp"] > 128 and plan["max_chunk"] == ML.MAX_CHUNK == 256
    assert plan["slice"] == ML.SLICE // 2 and plan["row_tiles_per_warp"] == 4
    assert plan["intra_smem"] <= SMEM_LIMIT
    assert plan["inter_smem"] <= SMEM_LIMIT
    assert plan["row_blocks"] == 2
    assert plan["intra_grid"] == (2 * (S // c), B * H)
    assert plan["m_slices"] == -(-m // 16) and plan["steps"] >= 2
    small = ML.launch_plan(B, S, H, m, 128 if S % 128 == 0 else 16)
    assert small["slice"] == ML.SLICE and small["row_blocks"] == 1


@pytest.mark.parametrize("B,S,H,m,c", ML_BIG[2:])
def test_mlstm_row_blocks_cover_each_score_and_output_once(B, S, H, m, c):
    """Pass 1 above 128: row block rb's warp w owns rows 128 rb + 16 w..;
    it takes key blocks 0..rb, all 16 tiles of 8 of a block before its
    own and the tiles to its diagonal of its own, so each (t, s <= t) of
    A is one block's once; A V's (row, column) once a slice of v.  Pass
    2: warps 4-7 own row tiles w + 4 r (r < 4) and write each (row,
    column) of h once; warps 0-1 update each (row, column) of the block's
    16 columns of C once a slice of 16, and n's columns once."""
    plan = ML.launch_plan(B, S, H, m, c)
    cp, rb_n = plan["cp"], plan["row_blocks"]
    g, t4 = _lanes()
    score = np.zeros((cp, cp), np.int64)
    av = np.zeros((c, m), np.int64)
    for rb in range(rb_n):
        r0 = rb * ML.ROW_BLOCK
        nr = min(cp - r0, ML.ROW_BLOCK)
        for w in range(8):
            if 16 * w >= nr:
                continue
            for kb in range(rb + 1):
                ntiles = 16 if kb < rb else min(2 * w + 2, nr // 8)
                for nt in range(ntiles):
                    for e in range(4):
                        t = r0 + 16 * w + g + 8 * (e >> 1)
                        s = kb * ML.ROW_BLOCK + 8 * nt + 2 * t4 + (e & 1)
                        np.add.at(score, (t, s), 1)
            for sl in range(-(-m // ML.SLICE)):
                for nt in range(ML.SLICE // 8):
                    for e in range(4):
                        t = r0 + 16 * w + g + 8 * (e >> 1)
                        i = sl * ML.SLICE + 8 * nt + 2 * t4 + (e & 1)
                        ok = (t < c) & (i < m)
                        np.add.at(av, (t[ok], i[ok]), 1)
    tt, ss = np.meshgrid(np.arange(cp), np.arange(cp), indexing="ij")
    assert (score[ss <= tt] == 1).all()  # every product a row needs
    assert (av == 1).all()
    sl, nm = plan["slice"], plan["m_slices"]
    out = np.zeros((c, m), np.int64)
    ccov = np.zeros((nm * sl, plan["inter_grid"][0] * ML.COLS), np.int64)
    ncov = np.zeros(nm * sl, np.int64)
    for bx in range(plan["inter_grid"][0]):
        e0 = bx * ML.COLS
        for w4 in range(4):
            for u in range(2 * plan["row_tiles_per_warp"]):
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
                if 16 * rt < sl:
                    for e in range(4):
                        row = z * sl + 16 * rt + g + 8 * (e >> 1)
                        col = e0 + 8 * nt + 2 * t4 + (e & 1)
                        np.add.at(ccov, (row, col), 1)
                lane = np.arange(32)
                if bx == 0 and 8 * warp < sl:
                    p0 = (lane >> 3) == 0
                    np.add.at(ncov, z * sl + 8 * warp + (lane & 7)[p0], 1)
    assert (out == 1).all()
    assert (ccov == 1).all() and (ncov == 1).all()


@pytest.mark.parametrize("B,S,H,m,c", ML_BIG)
def test_mlstm_backward_row_blocks_fit_and_cover_once(B, S, H, m, c):
    """The backward above 128: the grads kernel's row blocks of 128 keep a
    chunk of 128's tiles (and shared memory); over a chunk's blocks every
    (token, column) of dq, dk and dv is written once, each token's two
    shares once, and dC : C_in by row block 0 alone."""
    plan = ML.backward_plan(B, S, H, m, c)
    for key in ("state_smem", "scores_smem", "grads_smem"):
        assert plan[key] <= SMEM_LIMIT, key
    cp, ct, nrb = plan["cp"], plan["col_tiles"], plan["row_blocks"]
    assert nrb == 2 and plan["row_tiles"] == 8 and plan["nt"] == 8
    assert plan["grads_grid"] == ((S // c) * nrb * ct, B * H)
    assert plan["grads_smem"] == ML.backward_plan(1, 128, 1, m, 128)[
        "grads_smem"]
    g, t4 = _lanes()
    out = np.zeros((c, m), np.int64)
    parts = np.zeros((ct, 2 * c + 1), np.int64)
    for pt in range(ct):
        a0 = pt * ML.BWD_COLS
        for rb in range(nrb):
            rb0 = rb * ML.ROW_BLOCK
            nrt = min(cp - rb0, ML.ROW_BLOCK) // 16
            for w in range(nrt):  # tasks: one row tile a warp, 64 columns
                for nt in range(8):
                    for h in range(2):
                        t = rb0 + 16 * w + g + 8 * h
                        a = a0 + 8 * nt + 2 * t4
                        for d in range(2):
                            ok = (t < c) & (a + d < m)
                            np.add.at(out, (t[ok], a[ok] + d), 1)
            rows = rb0 + np.arange(min(cp, ML.ROW_BLOCK))
            rows = rows[rows < c]
            parts[pt, rows] += 1
            parts[pt, c + rows] += 1
            parts[pt, 2 * c] += rb == 0
    assert (out == 1).all() and (parts == 1).all()
