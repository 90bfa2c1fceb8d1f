"""The port's paged KV pool and paged-attention op against the JAX
package: ``repro_torch.core.paged_kv`` (the pool's bookkeeping, mirrored
from tests/test_paged_kv.py, and ``write_token``/``gather_kv`` against
the JAX functions) and ``repro_torch.kernels.paged_attention`` (its plain
version against the Pallas kernel in interpret mode, at
tests/test_kernels.py's sweep and tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paged_kv as jpkv
from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import ref as jref
from repro_torch.core.allocator import AllocError
from repro_torch.core.paged_kv import (
    SCRATCH_SEQ,
    PagedKVPool,
    gather_kv,
    init_pool_arrays,
    write_token,
)
from repro_torch.core.qos import QuotaExceeded
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_attention as PA

torch.set_num_threads(1)

SWEEP = [(2, 4, 4, 64, 16, 8, 4), (4, 8, 2, 64, 32, 16, 6),
         (1, 2, 1, 128, 8, 4, 2)]


def _inputs(rng, B, hq, hkv, d, P, page, npg, *, lengths=None):
    q = rng.normal(size=(B, hq, d)).astype(np.float32)
    kp = rng.normal(size=(P, page, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(P, page, hkv, d)).astype(np.float32)
    bt = np.stack([rng.choice(P, npg, replace=False)
                   for _ in range(B)]).astype(np.int32)
    ln = (rng.integers(1, npg * page + 1, size=(B,)) if lengths is None
          else np.asarray(lengths)).astype(np.int32)
    return q, kp, vp, bt, ln


def _both(q, kp, vp, bt, ln):
    """(port op on CPU tensors, Pallas kernel in interpret mode)."""
    got = ops.paged_attention(*(torch.from_numpy(a.copy())
                                for a in (q, kp, vp, bt, ln)))
    want = jops.paged_attention(*(jnp.asarray(a) for a in (q, kp, vp, bt, ln)))
    return got.numpy(), np.asarray(want)


# ------------------------------------------------------ paged attention ----
@pytest.mark.parametrize("B,hq,hkv,d,P,page,npg", SWEEP)
def test_paged_attention_plain_matches_pallas(B, hq, hkv, d, P, page, npg):
    rng = np.random.default_rng(B * 100 + d)
    got, want = _both(*_inputs(rng, B, hq, hkv, d, P, page, npg))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_paged_attention_rows_of_length_zero():
    """A row of length 0 (every inactive slot in both engines) is the
    uniform mean of V over all n_pages·page table positions — in the
    oracle, the Pallas kernel and the port's plain version alike; never
    NaN."""
    rng = np.random.default_rng(5)
    q, kp, vp, bt, ln = _inputs(rng, 3, 8, 2, 64, 16, 8, 5,
                                lengths=[0, 7, 0])
    got, want = _both(q, kp, vp, bt, ln)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    mean_v = vp[bt[0]].reshape(-1, 2, 64).mean(axis=0)  # (Hkv, d)
    np.testing.assert_allclose(got[0].reshape(2, 4, 64),
                               np.repeat(mean_v[:, None], 4, axis=1),
                               rtol=2e-4, atol=2e-4)


def test_paged_attention_repeated_pages():
    """Rows whose tables repeat one page (the scratch page, padding)."""
    rng = np.random.default_rng(6)
    q, kp, vp, _, ln = _inputs(rng, 2, 4, 2, 64, 8, 8, 4, lengths=[20, 3])
    bt = np.array([[3, 3, 5, 3], [0, 0, 0, 0]], np.int32)
    got, want = _both(q, kp, vp, bt, ln)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_paged_attention_plain_is_the_oracle_in_bf16():
    rng = np.random.default_rng(7)
    ins = _inputs(rng, 2, 8, 2, 128, 16, 16, 3)
    ts = [torch.from_numpy(a.copy()) for a in ins]
    for i in range(3):
        ts[i] = ts[i].bfloat16()
    got = ops.paged_attention(*ts)
    assert got.dtype == torch.bfloat16
    js = [jnp.asarray(a) for a in ins]
    js[:3] = [a.astype(jnp.bfloat16) for a in js[:3]]
    want = np.asarray(jref.paged_attention(*js).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_paged_attention_plain_is_cpu_only_route():
    """A CPU tensor reaches the plain version and never the kernel."""
    before = PA.launches
    rng = np.random.default_rng(8)
    ops.paged_attention(*(torch.from_numpy(a.copy())
                          for a in _inputs(rng, *SWEEP[0])))
    assert PA.launches == before


@pytest.mark.parametrize("change,err", [
    (dict(d=512), ValueError),             # wider than the kernel's head
    (dict(d=12), ValueError),              # not whole 16-byte vectors
    (dict(hq=6, hkv=4), ValueError),       # Hq not a multiple of Hkv
    (dict(hq=64, hkv=2, d=256), ValueError),  # (Hq/Hkv)·d over 4096
    (dict(table_dtype=np.int64), TypeError),
    (dict(q_dtype=torch.float64), TypeError),
])
def test_paged_attention_rejects(change, err):
    B, hq, hkv, d, P, page, npg = 2, change.get("hq", 4), \
        change.get("hkv", 2), change.get("d", 64), 8, 4, 2
    q = torch.zeros(B, hq, d, dtype=change.get("q_dtype", torch.float32))
    kp = torch.zeros(P, page, hkv, d)
    bt = torch.zeros(B, npg, dtype=torch.int32)
    if "table_dtype" in change:
        bt = torch.zeros(B, npg, dtype=torch.int64)
    ln = torch.ones(B, dtype=torch.int32)
    with pytest.raises(err):
        ops.paged_attention(q, kp, kp.clone(), bt, ln)


# -------------------------------------------------------------- the pool ----
def test_alloc_extend_free_cycle():
    pool = PagedKVPool(num_pages=32, page_size=8)
    t = pool.alloc_sequence(0, 20)  # 3 pages
    assert len(t) == 3 and pool.free_pages == 29
    t2 = pool.extend_sequence(0, 20)  # 40 tokens → 5 pages
    assert len(t2) == 5
    pool.free_sequence(0)
    assert pool.free_pages == 32


def test_fragment_fast_path_vs_fallback():
    pool = PagedKVPool(num_pages=6, page_size=4, allocator="nextfit")
    pool.alloc_sequence(0, 8)
    pool.alloc_sequence(1, 8)
    pool.alloc_sequence(2, 8)
    pool.free_sequence(0)
    pool.free_sequence(2)
    assert pool.fragment_allocs == 3
    d = pool.alloc_sequence(3, 12)
    assert pool.fallback_allocs == 1
    assert len(d) == 3


def test_pool_exhaustion_rolls_back():
    pool = PagedKVPool(num_pages=4, page_size=4)
    pool.alloc_sequence(0, 8)
    with pytest.raises(AllocError):
        pool.alloc_sequence(1, 16)
    assert pool.free_pages == 2


def test_scratch_page_is_pinned_and_unbilled():
    pool = PagedKVPool(num_pages=8, page_size=4, scratch=True)
    assert pool.scratch_page is not None
    assert pool.used_pages == 1
    pool.set_quota("t", 2)
    pool.alloc_sequence(0, 8, tenant="t")
    assert pool.tenant_pages("t") == 2
    with pytest.raises(ValueError, match="pinned"):
        pool.free_sequence(SCRATCH_SEQ)
    assert pool.used_pages == 3


def test_double_free_raises():
    pool = PagedKVPool(num_pages=8, page_size=4)
    pool.alloc_sequence(0, 4)
    pool.free_sequence(0)
    with pytest.raises(KeyError, match="double free"):
        pool.free_sequence(0)
    assert pool.free_pages == 8


def test_tenant_quota_enforced_and_released():
    pool = PagedKVPool(num_pages=16, page_size=4, scratch=True)
    pool.set_quota("small", 3)
    pool.alloc_sequence(0, 8, tenant="small")
    with pytest.raises(QuotaExceeded) as ei:
        pool.alloc_sequence(1, 8, tenant="small")
    assert ei.value.tenant == "small"
    pool.alloc_sequence(2, 8, tenant="big")
    pool.free_sequence(0)
    assert pool.tenant_pages("small") == 0
    pool.alloc_sequence(3, 12, tenant="small")
    assert pool.tenant_pages("small") == 3


def test_quota_rolls_back_when_pool_exhausted():
    pool = PagedKVPool(num_pages=4, page_size=4)
    pool.set_quota("t", 100)
    pool.alloc_sequence(0, 12, tenant="t")
    with pytest.raises(AllocError):
        pool.alloc_sequence(1, 8, tenant="t")
    assert pool.tenant_pages("t") == 3
    pool.free_sequence(0)
    assert pool.free_pages == 4


@pytest.mark.parametrize("allocator", ["bitset", "nextfit"])
def test_churn_assigns_the_same_pages_as_jax(allocator):
    """Continuous-batching churn: the port's pool hands out exactly the
    page ids the JAX package's does, never double-assigns, leaks
    nothing."""
    pools = [cls(num_pages=24, page_size=4, allocator=allocator,
                 scratch=True)
             for cls in (PagedKVPool, jpkv.PagedKVPool)]
    rng = np.random.default_rng(3)
    live = {}
    next_id = 0
    for _ in range(200):
        if live and (len(live) > 4 or rng.random() < 0.4):
            sid = sorted(live)[int(rng.integers(len(live)))]
            for p in pools:
                p.free_sequence(sid)
            del live[sid]
        else:
            n = int(rng.integers(1, 17))
            tables = [p.alloc_sequence(next_id, n) for p in pools]
            np.testing.assert_array_equal(tables[0], tables[1])
            live[next_id] = set(int(p) for p in tables[0])
            next_id += 1
        pages = [p for s in live.values() for p in s]
        assert len(pages) == len(set(pages)), "page double-assigned"
        assert pools[0].scratch_page not in pages
        assert pools[0].used_pages == len(pages) + 1
        assert pools[0].used_pages == pools[1].used_pages
    for sid in sorted(live):
        pools[0].free_sequence(sid)
    assert pools[0].used_pages == 1


# ------------------------------------------- device helpers vs the JAX ones --
def test_write_and_gather_roundtrip():
    pool = PagedKVPool(num_pages=16, page_size=4)
    table = pool.alloc_sequence(7, 16)
    bt = np.zeros((1, 4), np.int32)
    bt[0, : len(table)] = table
    k, v = init_pool_arrays(16, 4, 2, 8, torch.float32, device="cpu")
    assert not k.any() and not v.any()  # zero-filled: the scratch page too
    vals = []
    for pos in range(10):
        new = torch.full((1, 2, 8), float(pos + 1))
        k = write_token(k, torch.from_numpy(bt), torch.tensor([pos]), new)
        vals.append(pos + 1.0)
    dense = gather_kv(k, torch.from_numpy(bt), 16)
    np.testing.assert_allclose(dense[0, :10, 0, 0].numpy(), vals)


def test_write_token_and_gather_kv_match_jax():
    rng = np.random.default_rng(11)
    P, page, hkv, d, B, npg = 12, 4, 2, 8, 3, 3
    pool0 = rng.normal(size=(P, page, hkv, d)).astype(np.float32)
    bt = np.stack([rng.choice(P, npg, replace=False)
                   for _ in range(B)]).astype(np.int32)
    jpool, tpool = jnp.asarray(pool0), torch.from_numpy(pool0.copy())
    for step in range(5):
        pos = rng.integers(0, npg * page, size=(B,)).astype(np.int32)
        new = rng.normal(size=(B, hkv, d)).astype(np.float32)
        jpool = jpkv.write_token(jpool, jnp.asarray(bt), jnp.asarray(pos),
                                 jnp.asarray(new))
        got = write_token(tpool, torch.from_numpy(bt), torch.from_numpy(pos),
                          torch.from_numpy(new))
        assert got is tpool  # in place
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(
        gather_kv(tpool, torch.from_numpy(bt), npg * page).numpy(),
        np.asarray(jpkv.gather_kv(jpool, jnp.asarray(bt), npg * page)))
