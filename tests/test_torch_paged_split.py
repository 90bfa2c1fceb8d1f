"""The paged-attention kernel's split plan and its split-and-combine
arithmetic, held against the JAX package's paged kernel.

The CUDA kernel (``csrc/paged_attention.cu``) splits each sequence's
table into runs of whole pages (``split_plan``), computes float32
partials (m, l, acc) per split with an online softmax over chunks of 64
positions, and merges the splits in split order.  It runs only on the
card, so here the same arithmetic is written in torch
(:func:`split_combine`) and compared with the JAX package's Pallas
kernel in interpret mode and with the reference oracle, at
``tests/test_kernels.py``'s sweep plus tables with several splits, rows
of length 0 and splits past a row's length.  Inputs come from a numpy
seed.  The kernel itself is held against the plain version on the card
by ``tests/test_torch_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jpa
from repro.kernels.paged_attention import ref as jpa_ref
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.paged_attention import paged_attention as PA

torch.set_num_threads(1)

NEG_INF = -1e30


def split_ranges(n_pages, page):
    """[start, stop) positions of each split of a table, in split order."""
    pps, n_splits = PA.split_plan(n_pages, page)
    total = n_pages * page
    return [(s * pps * page, min((s + 1) * pps * page, total))
            for s in range(n_splits)]


def split_combine(q, kp, vp, bt, ln, chunk=64):
    """The kernel's arithmetic in torch, float32: per split, an online
    softmax over chunks of ``chunk`` positions (a row of length 0 scores
    -1e30 everywhere without reading K; a split at or past a row's length
    gives m = -1e30, l = 0, acc = 0); then the splits merged in order."""
    B, hq, d = q.shape
    _, page, hkv, _ = kp.shape
    n_pages = bt.shape[1]
    group = hq // hkv
    out = torch.empty(B, hq, d)
    for b in range(B):
        L = int(ln[b])
        parts = []
        for t0, t1 in split_ranges(n_pages, page):
            end = t1 if L <= 0 else min(t1, L)
            m = torch.full((hq,), NEG_INF)
            l = torch.zeros(hq)
            acc = torch.zeros(hq, d)
            for c0 in range(t0, end, chunk):
                t = torch.arange(c0, min(c0 + chunk, end))
                pid = bt[b, t // page].long().clamp(0, kp.shape[0] - 1)
                k = kp[pid, t % page].float()  # (n, Hkv, d)
                v = vp[pid, t % page].float()
                kr = k.repeat_interleave(group, dim=1)  # (n, Hq, d)
                vr = v.repeat_interleave(group, dim=1)
                if L <= 0:
                    s = torch.full((hq, len(t)), NEG_INF)
                else:
                    s = torch.einsum("hd,nhd->hn", q[b].float(), kr)
                    s = s / math.sqrt(d)
                m_new = torch.maximum(m, s.amax(dim=1))
                p = torch.exp(s - m_new[:, None])
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(dim=1)
                acc = alpha[:, None] * acc + torch.einsum("hn,nhd->hd", p, vr)
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        num = torch.zeros(hq, d)
        den = torch.zeros(hq)
        for m, l, acc in parts:  # split order
            w = torch.exp(m - M)
            den = den + w * l
            num = num + w[:, None] * acc
        out[b] = num / den.clamp_min(1e-30)[:, None]
    return out


def paged_inputs(seed, B, hq, hkv, d, P, page, npg, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, hq, d)).astype(np.float32)
    kp = rng.normal(size=(P, page, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(P, page, hkv, d)).astype(np.float32)
    bt = np.stack([rng.choice(P, npg, replace=False)
                   for _ in range(B)]).astype(np.int32)
    if lengths is None:
        ln = rng.integers(1, npg * page + 1, size=(B,)).astype(np.int32)
    else:
        ln = np.asarray(lengths, np.int32)
    return q, kp, vp, bt, ln


# (B, Hq, Hkv, d, P, page, n_pages, lengths): tests/test_kernels.py's
# sweep, then tables of several splits with rows of length 0 and rows
# that end before their later splits begin, the last with an odd group
CASES = [
    (2, 4, 4, 64, 16, 8, 4, None),
    (4, 8, 2, 64, 32, 16, 6, None),
    (1, 2, 1, 128, 8, 4, 2, None),
    (3, 8, 2, 64, 64, 4, 40, [0, 10, 150]),
    (4, 4, 1, 32, 240, 1, 200, [200, 0, 64, 65]),
    (4, 32, 8, 16, 128, 16, 32, [100, 0, 0, 0]),
    (2, 4, 2, 64, 40, 16, 20, [0, 0]),
    (2, 3, 1, 24, 32, 4, 20, [50, 0]),
]


@pytest.mark.parametrize("B,hq,hkv,d,P,page,npg,lengths", CASES)
def test_split_combine_matches_pallas(B, hq, hkv, d, P, page, npg, lengths):
    ins = paged_inputs(P + npg, B, hq, hkv, d, P, page, npg, lengths)
    want = np.asarray(jpa.paged_attention(*(jnp.asarray(x) for x in ins)))
    got = split_combine(*(torch.from_numpy(x) for x in ins))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,hq,hkv,d,P,page,npg,lengths", CASES)
def test_split_combine_matches_oracle_and_plain(B, hq, hkv, d, P, page, npg,
                                                lengths):
    ins = paged_inputs(P + d, B, hq, hkv, d, P, page, npg, lengths)
    want = np.asarray(jpa_ref.paged_attention(*(jnp.asarray(x)
                                                for x in ins)))
    t_ins = [torch.from_numpy(x) for x in ins]
    got = split_combine(*t_ins)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), tpa.paged_attention(*t_ins),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_pages", [0, 1, 2, 4, 6, 15, 16, 17, 32, 40, 100,
                                     255, 256, 257, 1000])
@pytest.mark.parametrize("page", [1, 4, 8, 16, 64, 128])
def test_split_plan_covers_each_position_once(n_pages, page):
    pps, n_splits = PA.split_plan(n_pages, page)
    assert pps >= 1 and 1 <= n_splits <= PA.MAX_SPLITS
    ranges = split_ranges(n_pages, page)
    # whole pages, in order, back to back, covering the table once
    assert all(t0 % page == 0 for t0, _ in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_pages * page
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(t0 < t1 for t0, t1 in ranges) or n_pages == 0
    # at least one kernel chunk a split where the table is that long
    if n_pages * page >= PA.SPLIT_POSITIONS:
        assert all(t1 - t0 >= PA.SPLIT_POSITIONS
                   for t0, t1 in ranges[:-1])


def test_split_plan_depends_on_the_table_alone():
    """The plan is a function of (n_pages, page): the same for every
    batch, pool, dtype and length, and it fills the card at the serving
    shapes (B 4, Hkv 8, 32 pages of 16) and at B 8 x 4096 tokens."""
    import inspect

    assert list(inspect.signature(PA.split_plan).parameters) == ["n_pages",
                                                                 "page"]
    assert PA.split_plan(32, 16) == (4, 8)
    assert 4 * 8 * PA.split_plan(32, 16)[1] >= 132
    assert 8 * 8 * PA.split_plan(256, 16)[1] >= 132
