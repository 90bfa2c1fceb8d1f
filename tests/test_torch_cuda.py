"""The port's hand-written CUDA kernels and its paths on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode).  This file imports neither JAX
nor the JAX package, so it runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import rimms
from repro_torch.apps import radar
from repro_torch.kernels.fft import fft as F
from repro_torch.kernels.fft import ops as fft_ops
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mlstm import mlstm as ML
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import paged_attention as PA
from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.kernels.rg_lru import rg_lru as RL
from repro_torch.kernels.zip import ops as zip_ops
from repro_torch.kernels.zip import zip as Z

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def fft_tol(n):
    # tests/test_kernels.py's tolerances: f32 twiddles, and the kernel
    # sums in another order than the plain version.  They are sized for
    # forward outputs (about sqrt(n)); an inverse (about 1/sqrt(n)) is
    # compared times n, which a power of two scales exactly.
    rtol = 3e-3 if n >= 2048 else 5e-4
    return rtol, rtol * math.sqrt(n)


def assert_fft_close(got, want, n, fwd):
    """got within fft_tol(n) of want, both times n for an inverse."""
    rtol, atol = fft_tol(n)
    s = 1 if fwd else n
    torch.testing.assert_close(got * s, want * s, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [2, 64, 512, 2048, 8192])
def test_fft_kernel_matches_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(3, n, dtype=torch.complex64, device=cuda, generator=gen)
    before = F.launches
    for fwd in (True, False):
        got = fft_ops.fft(x, fwd)
        assert_fft_close(got, F.fft_plain(x, inverse=not fwd), n, fwd)
        assert torch.equal(got, fft_ops.fft(x, fwd, block_rows=32))
    assert F.launches == before + 4


@pytest.mark.parametrize("shape", [(64,), (3, 300), (131072,)])
def test_zip_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(len(shape))
    a = torch.randn(*shape, dtype=torch.complex64, device=cuda, generator=gen)
    b = torch.randn(*shape, dtype=torch.complex64, device=cuda, generator=gen)
    before = Z.launches
    got = zip_ops.zip_mul(a, b)
    torch.testing.assert_close(got, Z.zip_plain(a, b), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, zip_ops.zip_mul(a, b, block_rows=4096))
    assert Z.launches == before + 2


@pytest.mark.parametrize("n", [2 ** p for p in range(1, 14)])
def test_fft_kernel_every_length_and_rows(cuda, n):
    """Every power of two from 2 to 8192 in 1, 3, 128 and 1024 rows,
    forward and inverse, against the plain version; block_rows 8/32/128
    bit-identical; the input left unwritten."""
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    for rows in (1, 3, 128, 1024):
        x = torch.randn(rows, n, dtype=torch.complex64, device=cuda,
                        generator=gen)
        before = x.clone()
        for fwd in (True, False):
            got = fft_ops.fft(x, fwd)
            assert_fft_close(got, F.fft_plain(x, inverse=not fwd), n, fwd)
            for br in (32, 128):
                assert torch.equal(fft_ops.fft(x, fwd, block_rows=br), got)
        assert torch.equal(x, before)


@pytest.mark.parametrize("offset,n", [(1, 2048), (3, 512), (5, 64),
                                      (7, 8192)])
def test_fft_kernel_rows_at_odd_offset(cuda, offset, n):
    """Two rows of a view at an odd element (8 bytes past a 16-byte
    boundary): within tolerance of the plain version, bit-equal to the
    same rows at an aligned address, the base left unwritten."""
    gen = torch.Generator(device=cuda).manual_seed(offset)
    base = torch.randn(offset + 2 * n + 1, dtype=torch.complex64,
                       device=cuda, generator=gen)
    before = base.clone()
    view = base[offset:offset + 2 * n].view(2, n)
    for fwd in (True, False):
        got = fft_ops.fft(view, fwd)
        assert_fft_close(got, F.fft_plain(view, inverse=not fwd), n, fwd)
        assert torch.equal(got, fft_ops.fft(view.clone(), fwd))
    assert torch.equal(base, before)


@pytest.mark.parametrize("n", [2 ** p for p in range(14, 22)])
def test_fft_kernel_four_step_every_large_length(cuda, n):
    """Every power of two from 16384 to 2^21 (two launches, one count) in
    1 and 3 rows, forward and inverse, against the plain version and
    torch.fft; block_rows has no effect; a row's bits do not depend on
    the rows beside it; the input is left unwritten."""
    gen = torch.Generator(device=cuda).manual_seed(n + 3)
    for rows in (1, 3):
        x = torch.randn(rows, n, dtype=torch.complex64, device=cuda,
                        generator=gen)
        before = x.clone()
        for fwd in (True, False):
            count = F.launches
            got = fft_ops.fft(x, fwd)
            assert F.launches == count + 1
            assert_fft_close(got, F.fft_plain(x, inverse=not fwd), n, fwd)
            lib = torch.fft.fft(x) if fwd else torch.fft.ifft(x)
            assert_fft_close(got, lib, n, fwd)
            for br in (32, 128):
                assert torch.equal(fft_ops.fft(x, fwd, block_rows=br), got)
            assert torch.equal(fft_ops.fft(x[-1:].clone(), fwd), got[-1:])
        assert torch.equal(x, before)


@pytest.mark.parametrize("offset,n", [(1, 16384), (3, 32768)])
def test_fft_kernel_four_step_at_odd_offset(cuda, offset, n):
    """Large rows of a view at an odd element: bit-equal to the same rows
    at an aligned address, the base left unwritten."""
    gen = torch.Generator(device=cuda).manual_seed(offset + n)
    base = torch.randn(offset + 2 * n + 1, dtype=torch.complex64,
                       device=cuda, generator=gen)
    before = base.clone()
    view = base[offset:offset + 2 * n].view(2, n)
    for fwd in (True, False):
        got = fft_ops.fft(view, fwd)
        assert_fft_close(got, F.fft_plain(view, inverse=not fwd), n, fwd)
        assert torch.equal(got, fft_ops.fft(view.clone(), fwd))
    assert torch.equal(base, before)


@pytest.mark.parametrize("oa,ob,n", [(1, 0, 512), (0, 1, 511), (1, 1, 1001),
                                     (3, 6, 1), (0, 1, 2), (5, 2, 131072)])
def test_zip_kernel_views_at_any_phase(cuda, oa, ob, n):
    """a and b at different 16-byte phases and odd offsets, odd lengths:
    within 1e-5 of the plain version, bit-equal to aligned copies,
    block_rows 256/1024/4096 bit-identical, the inputs unwritten."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    A, B = (torch.randn(n + 8, dtype=torch.complex64, device=cuda,
                        generator=gen) for _ in range(2))
    keep = (A.clone(), B.clone())
    a, b = A[oa:oa + n], B[ob:ob + n]
    before = Z.launches
    got = zip_ops.zip_mul(a, b)
    torch.testing.assert_close(got, Z.zip_plain(a, b), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, zip_ops.zip_mul(a.clone(), b.clone()))
    for br in (1024, 4096):
        assert torch.equal(got, zip_ops.zip_mul(a, b, block_rows=br))
    assert Z.launches == before + 4
    assert torch.equal(A, keep[0]) and torch.equal(B, keep[1])


def test_main_path_runs_on_kernels(cuda):
    """2FZF on one GPU PE under RIMMS: 2 copies in, every op a kernel
    launch, the output right against numpy."""
    fft0, zip0 = F.launches, Z.launches
    rt, ctx = radar.make_runtime(policy="rimms")  # device=None: CUDA
    bufs, tasks = radar.build_2fzf(ctx, 1024, pins=("gpu0",) * 4, seed=5)
    radar.run_pipeline(rt, tasks)
    assert ctx.ledger.total_copies == 2
    assert (F.launches - fft0, Z.launches - zip0) == (3, 1)
    assert bufs["out"].copies[bufs["out"].last_location].is_cuda
    want = np.fft.ifft(np.fft.fft(bufs["a"].data) * np.fft.fft(bufs["b"].data))
    np.testing.assert_allclose(ctx.sync(bufs["out"]), want,
                               rtol=1e-3, atol=1e-3 * math.sqrt(1024))


@pytest.mark.parametrize("n", [3, 12, 1000, 1536, 4095, 12289, 100000,
                               524287, (1 << 20) - 1])
def test_fft_any_length_through_bluestein(cuda, n):
    """A length that is not a power of two: one fused launch a call (one
    FFT count, no ZIP count), bit-equal to the composition of the FFT and
    ZIP kernels it replaces, within tolerance of the composition over the
    plain versions and of numpy's complex128 FFT; bit-identical across
    block_rows."""
    from repro_torch.kernels.fft import bluestein as BL

    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(2, n, dtype=torch.complex64, device=cuda, generator=gen)
    BL.tables(n, False, cuda), BL.tables(n, True, cuda)
    for fwd in (True, False):
        counts = (F.launches, Z.launches)
        got = fft_ops.fft(x, fwd)
        assert (F.launches, Z.launches) == (counts[0] + 1, counts[1])
        composed = BL.bluestein(
            x, inverse=not fwd,
            fft=lambda a, inv: F.fft_kernel(a, inverse=inv), mul=Z.zip_kernel)
        assert torch.equal(got, composed)
        s = 1 if fwd else n
        want = BL.bluestein_plain(x, inverse=not fwd)
        # the power-of-two rtol and atol of its inner length (3e-3)
        tol = 3e-3 * (math.sqrt(n) + float(want.abs().max() * s))
        assert float((got - want).abs().max() * s) <= tol
        ref = np.fft.fft(x.cpu().numpy().astype(np.complex128)) if fwd \
            else np.fft.ifft(x.cpu().numpy().astype(np.complex128)) * n
        assert float(np.abs(got.cpu().numpy() * s - ref).max()) <= tol
        for br in (32, 128):
            assert torch.equal(fft_ops.fft(x, fwd, block_rows=br), got)


@pytest.mark.parametrize("n", [12, 1000, 4095, 12289, 100000])
def test_bluestein_row_bits_do_not_depend_on_other_rows(cuda, n):
    """A row's output through the fused route has the same bits alone, in
    a batch of 3 and in a batch of 64, at any block_rows."""
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    x = torch.randn(64, n, dtype=torch.complex64, device=cuda, generator=gen)
    for fwd in (True, False):
        batch = fft_ops.fft(x, fwd)
        three = fft_ops.fft(x[5:8].contiguous(), fwd, block_rows=32)
        assert torch.equal(three, batch[5:8])
        for i in (0, 6, 63):
            alone = fft_ops.fft(x[i:i + 1].contiguous(), fwd)
            assert torch.equal(alone[0], batch[i])


#: tests/test_kernels.py's sweep in both dtypes, the ragged S = 300
#: non-causal case with block_k 100, and S not a multiple of 16 or 64
FLASH_CASES = [
    (B, S, Hq, Hkv, d, bk, dt, causal)
    for B, S, Hq, Hkv, d, bk, causal in (
        (2, 256, 4, 2, 64, 128, True),
        (1, 512, 2, 1, 128, 256, True),
        (2, 128, 4, 4, 64, 64, True),
        (1, 384, 2, 2, 64, 128, True),
        (1, 300, 4, 1, 128, 100, False),
        (1, 300, 4, 1, 128, 100, True),
        (2, 197, 4, 2, 64, 64, True),
        (1, 77, 2, 2, 128, 512, False),
        # head widths run at a padded compiled width, and element-wise
        # loads (d not a multiple of 16 bytes' elements)
        (1, 256, 2, 2, 32, 128, True), (1, 200, 2, 1, 80, 100, False),
        (1, 256, 2, 2, 96, 128, True), (1, 200, 4, 2, 160, 64, True),
        (1, 256, 2, 2, 256, 128, True), (2, 130, 2, 2, 33, 64, False),
        (1, 96, 2, 1, 36, 64, True))
    for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("B,S,Hq,Hkv,d,bk,dtype,causal", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, S, Hq, Hkv, d, bk,
                                              dtype, causal):
    """Against the plain version at the same block_k (2e-4 in float32,
    2e-2 in bf16), and bit-identical across block_q 128/256/512."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(B, S, h, d, device=cuda, generator=gen).to(dtype)
               for h in (Hq, Hkv, Hkv))
    before = FA.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, block_k=bk)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got.float(), FA.flash_attention_plain(
            q, k, v, causal=causal, block_k=min(bk, S)).float(),
        rtol=tol, atol=tol)
    for bq in (128, 512):
        assert torch.equal(got, flash_ops.flash_attention(
            q, k, v, causal=causal, block_q=bq, block_k=bk))
    assert FA.launches == before + 3


@pytest.mark.parametrize("B,S,D", [(2, 32, 128), (3, 64, 200), (1, 256, 2560),
                                   (2, 200, 384), (1, 2048, 512)])
def test_rg_lru_kernel_bit_equal_to_plain(cuda, B, S, D):
    gen = torch.Generator(device=cuda).manual_seed(D)
    a = torch.rand(B, S, D, device=cuda, generator=gen) * 0.7 + 0.3
    b = torch.randn(B, S, D, device=cuda, generator=gen)
    h0 = torch.randn(B, D, device=cuda, generator=gen)
    before = RL.launches
    hs, hn = rg_ops.rg_lru_scan(a, b, h0)
    ws, wn = RL.rg_lru_plain(a, b, h0)
    assert torch.equal(hs, ws) and torch.equal(hn, wn)
    for lanes in (256, 512):
        got = rg_ops.rg_lru_scan(a, b, h0, block_lanes=lanes)
        assert torch.equal(got[0], hs) and torch.equal(got[1], hn)
    assert RL.launches == before + 3


@pytest.mark.parametrize("B,S,H,m,chunk", [(2, 64, 2, 128, 16),
                                           (1, 32, 4, 64, 8),
                                           (1, 256, 2, 512, 64),
                                           (1, 512, 2, 512, 256),
                                           (1, 400, 1, 40, 200),
                                           (1, 512, 1, 1024, 256)])
def test_mlstm_kernel_matches_plain(cuda, B, S, H, m, chunk):
    gen = torch.Generator(device=cuda).manual_seed(m)
    q, k, v = (torch.randn(B, S, H, m, device=cuda, generator=gen) * sc
               for sc in (1.0, 0.3, 1.0))
    ig = torch.rand(B, S, H, device=cuda, generator=gen) * 0.8 + 0.1
    lf = torch.log(torch.rand(B, S, H, device=cuda, generator=gen) * 0.45
                   + 0.5)
    before = ML.launches
    got = mlstm_ops.mlstm_chunkwise(q, k, v, ig, lf, chunk=chunk)
    torch.testing.assert_close(
        got, ML.mlstm_plain(q, k, v, ig, lf, chunk=chunk),
        rtol=2e-3, atol=2e-3)
    assert ML.launches == before + 1


@pytest.mark.parametrize("B,S,H,m,chunk", [(2, 64, 2, 128, 16),
                                           (1, 32, 4, 64, 8),
                                           (1, 128, 1, 128, 64),
                                           (1, 96, 1, 33, 32),
                                           (1, 64, 2, 24, 64),
                                           (2, 2047, 4, 512, 89),
                                           (2, 2048, 4, 512, 128)])
def test_mlstm_kernel_state_matches_plain(cuda, B, S, H, m, chunk):
    """``return_state``: the final C and n within 2e-3 of the plain
    version's (the reference's sweep, ragged widths, and xlstm-350m's
    prefill at 2047 and 2048 tokens); h bit-identical to a call without
    the state; one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(S + m)
    q, k, v = (torch.randn(B, S, H, m, device=cuda, generator=gen) * sc
               for sc in (1.0, 0.3, 1.0))
    ig = torch.rand(B, S, H, device=cuda, generator=gen) * 0.8 + 0.1
    lf = torch.log(torch.rand(B, S, H, device=cuda, generator=gen) * 0.45
                   + 0.5)
    ins = (q, k, v, ig, lf)
    before = ML.launches
    h, C, n = mlstm_ops.mlstm_chunkwise(*ins, chunk=chunk, return_state=True)
    assert ML.launches == before + 1
    wh, wc, wn = ML.mlstm_plain(*ins, chunk=chunk, return_state=True)
    assert C.shape == (B, H, m, m) and n.shape == (B, H, m)
    for got, want in ((h, wh), (C, wc), (n, wn)):
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    assert torch.equal(h, mlstm_ops.mlstm_chunkwise(*ins, chunk=chunk))


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_mlstm_kernel_at_the_ladders_top_rung(cuda, chunk):
    """The autotuner's 8 MiB rung, (1, 5376, 2, 64), at each chunk
    candidate: within 2e-3 of plain, and the inputs unwritten."""
    gen = torch.Generator(device=cuda).manual_seed(chunk)
    q, k, v = (torch.randn(1, 5376, 2, 64, device=cuda, generator=gen) * sc
               for sc in (1.0, 0.3, 1.0))
    ig = torch.randn(1, 5376, 2, device=cuda, generator=gen)
    lf = -torch.randn(1, 5376, 2, device=cuda, generator=gen).abs()
    ins = (q, k, v, ig, lf)
    kept = [x.clone() for x in ins]
    got = mlstm_ops.mlstm_chunkwise(*ins, chunk=chunk)
    torch.testing.assert_close(got, ML.mlstm_plain(*ins, chunk=chunk),
                               rtol=2e-3, atol=2e-3)
    assert all(torch.equal(x, y) for x, y in zip(ins, kept))


def test_autotune_dispatches_kernels_on_gpu(cuda):
    """A tuned op submitted to a gpu PE after autotuning runs the CUDA
    kernel of the variant the table names."""
    session = rimms.Session.emulated(n_cpu=1, accelerators=("gpu0",),
                                     registry=rimms.OpRegistry())
    try:
        table = rimms.autotune(session, nbytes=[16 << 10], k=1, warmup=1)
        tun = next(t for t in rimms.tunables() if t.op == "flash_attention")
        ins = tun.make_inputs(np.random.default_rng([0, 16 << 10]), 16 << 10)
        session.runtime.reset_stats()
        before = FA.launches
        out = session.submit("flash_attention", ins, pin="gpu0").result()
        session.barrier()
        assert FA.launches == before + 1
        win = table.winner("flash_attention", "gpu",
                           sum(a.nbytes for a in ins))["variant"]
        want = [] if win == rimms.DEFAULT_VARIANT else [
            ("flash_attention", "gpu", win)]
        assert session.runtime.variant_log == want
        ref = tun.fn([torch.from_numpy(a).to(cuda) for a in ins])[0]
        assert np.array_equal(out, ref.cpu().numpy())
    finally:
        session.close()


@pytest.mark.parametrize("B,hq,hkv,d,P,page,npg,dtype", [
    (2, 4, 4, 64, 16, 8, 4, torch.float32),
    (4, 8, 2, 64, 32, 16, 6, torch.float32),
    (1, 2, 1, 128, 8, 4, 2, torch.float32),
    (3, 32, 8, 128, 96, 16, 32, torch.bfloat16),
    (2, 21, 1, 192, 64, 16, 32, torch.bfloat16),
    (2, 34, 2, 240, 64, 16, 32, torch.float32),
    (3, 9, 3, 72, 32, 8, 12, torch.float32),
])
def test_paged_attention_kernel_matches_plain(cuda, B, hq, hkv, d, P, page,
                                              npg, dtype):
    """tests/test_kernels.py's sweep, a llama3-8b-width case and odd
    groups up to (Hq / Hkv) * d = 4096; row 0 of length 0 (the uniform
    mean of V), never NaN."""
    gen = torch.Generator(device=cuda).manual_seed(P)
    q = torch.randn(B, hq, d, device=cuda, generator=gen).to(dtype)
    kp, vp = (torch.randn(P, page, hkv, d, device=cuda,
                          generator=gen).to(dtype) for _ in range(2))
    bt = torch.stack([torch.randperm(P, device=cuda, generator=gen)[:npg]
                      for _ in range(B)]).int()
    ln = torch.randint(1, npg * page + 1, (B,), device=cuda, generator=gen)
    ln[0] = 0
    ln = ln.int()
    before = PA.launches
    got = pa_ops.paged_attention(q, kp, vp, bt, ln)
    assert PA.launches == before + 1
    assert torch.isfinite(got).all()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(
        got.float(), PA.paged_attention_plain(q, kp, vp, bt, ln).float(),
        rtol=tol, atol=tol)


def test_serving_engines_launch_the_kernel(cuda):
    """Both engines on the card (device=None): the same tokens, one
    paged-attention launch per layer and decode step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.session_engine import SessionServeEngine

    cfg = dataclasses.replace(get_config("llama3_8b").smoke(),
                              dtype="bfloat16")
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    work = [(rng.integers(1, cfg.vocab, int(rng.integers(2, 9))).tolist(),
             int(rng.integers(2, 6))) for _ in range(6)]
    kw = dict(max_batch=3, page_size=8, num_pages=64, max_pages_per_seq=8)
    streams = []
    for make in (lambda: ServeEngine(cfg, params, **kw),
                 lambda: SessionServeEngine(cfg, params, pages_per_group=8,
                                            **kw)):
        eng = make()
        before = PA.launches
        reqs = [eng.submit(p, m) for p, m in work]
        eng.run()
        assert all(r.done for r in reqs)
        assert PA.launches - before == cfg.n_layers * eng.decode_steps > 0
        streams.append([r.generated for r in reqs])
        if isinstance(eng, SessionServeEngine):
            assert eng.kv.used_pages == 1
            eng.close()
    assert streams[0] == streams[1]


def _serving_paged_inputs(cuda, lengths, seed=0):
    """The serving path's shapes: B 4, Hq 32, Hkv 8, d 128, 16-token
    pages, 32-page tables, bf16."""
    B, npg = len(lengths), 32
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, 32, 128, device=cuda, generator=gen).bfloat16()
    kp, vp = (torch.randn(B * npg, 16, 8, 128, device=cuda,
                          generator=gen).bfloat16() for _ in range(2))
    bt = torch.randperm(B * npg, device=cuda,
                        generator=gen).reshape(B, npg).int()
    return q, kp, vp, bt, torch.tensor(lengths, dtype=torch.int32,
                                       device=cuda)


def test_paged_attention_row_is_bit_equal_whatever_the_other_rows(cuda):
    """Lengths [100, 0, 0, 0] (a teacher-forced prefill step) and
    [100, 37, 5, 0]: every row within tolerance of the plain version, and
    row 0 bit-equal across the two (what keeps the serving engines'
    tokens equal)."""
    outs = []
    for lengths in ([100, 0, 0, 0], [100, 37, 5, 0]):
        q, kp, vp, bt, ln = _serving_paged_inputs(cuda, lengths)
        got = pa_ops.paged_attention(q, kp, vp, bt, ln)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(
            got.float(), PA.paged_attention_plain(q, kp, vp, bt, ln).float(),
            rtol=2e-2, atol=2e-2)
        outs.append(got)
    assert torch.equal(outs[0][0], outs[1][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_lengths_at_split_edges(cuda, dtype):
    """Lengths on a split boundary, one past it, one short of it, in the
    last page and at the table's end, against the plain version."""
    npg, page = 32, 16
    pps, _ = PA.split_plan(npg, page)
    edge = pps * page
    lengths = [edge, edge + 1, edge - 1, 2 * edge, (npg - 1) * page + 3,
               npg * page, 1, 0]
    q, kp, vp, bt, ln = _serving_paged_inputs(cuda, lengths, seed=1)
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    got = pa_ops.paged_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(
        got.float(), PA.paged_attention_plain(q, kp, vp, bt, ln).float(),
        rtol=tol, atol=tol)


def _grad_cases(dev):
    """Each kernel wrapper with small valid CUDA inputs, the float ones
    requiring grad."""
    f32 = dict(device=dev, dtype=torch.float32)
    c64 = dict(device=dev, dtype=torch.complex64)

    def leaf(*shape, **kw):
        return torch.randn(*shape, **kw).requires_grad_(True)

    table = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    return {
        "fft": lambda: fft_ops.fft(leaf(2, 64, **c64)),
        "zip_mul": lambda: zip_ops.zip_mul(leaf(2, 64, **c64),
                                           torch.randn(2, 64, **c64)),
        "flash_attention": lambda: flash_ops.flash_attention(
            leaf(1, 64, 2, 64, **f32), torch.randn(1, 64, 2, 64, **f32),
            torch.randn(1, 64, 2, 64, **f32)),
        "paged_attention": lambda: pa_ops.paged_attention(
            leaf(2, 4, 64, **f32), torch.randn(4, 16, 2, 64, **f32),
            torch.randn(4, 16, 2, 64, **f32), table,
            torch.tensor([5, 0], dtype=torch.int32, device=dev)),
    }


@pytest.mark.parametrize("name", ["fft", "zip_mul", "flash_attention",
                                  "paged_attention"])
def test_wrappers_refuse_grad_on_cuda(cuda, name):
    """A CUDA input that requires grad, with grad mode on, raises (these
    kernels have no backward, ROADMAP C.15) instead of returning an output
    cut from the graph; under ``torch.no_grad()`` the kernel runs."""
    call = _grad_cases(cuda)[name]
    with pytest.raises(NotImplementedError, match=f"{name}.*no backward"):
        call()
    with torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    first = out[0] if isinstance(out, tuple) else out
    assert first.grad_fn is None and first.is_cuda


@pytest.mark.parametrize("B,S,H,m,chunk,state", [
    (2, 48, 3, 40, 16, False), (1, 64, 2, 64, 64, False),
    (1, 256, 2, 64, 32, True), (1, 1024, 4, 512, 128, False),
    # ragged edges: m past a 64-column tile, chunks not multiples of 16
    (1, 96, 1, 200, 48, True), (1, 80, 2, 96, 40, False),
    (1, 30, 2, 33, 10, True), (1, 240, 1, 72, 120, False),
    (1, 256, 1, 1024, 128, True),
    # chunks past 128: the grads pass in row blocks of 128
    (1, 1024, 4, 512, 256, False), (1, 512, 2, 64, 256, True),
    (1, 400, 1, 40, 200, False)])
def test_mlstm_backward_kernel_matches_autograd_of_plain(cuda, B, S, H, m,
                                                         chunk, state):
    """``loss.backward()`` through ``mlstm_chunkwise`` on the card
    launches the forward and backward kernels once each and gives
    autograd's gradients through ``mlstm_plain``: each within 1e-4 of
    its max (1e-3 at xLSTM's width, m >= 512)."""
    gen = torch.Generator(device=cuda).manual_seed(S + m)
    ins = [torch.randn(B, S, H, m, device=cuda, generator=gen)
           for _ in range(3)]
    ins += [torch.rand(B, S, H, device=cuda, generator=gen),
            -torch.rand(B, S, H, device=cuda, generator=gen)]
    leaves = [t.clone().requires_grad_(True) for t in ins]
    before = (ML.launches, ML.backward_launches)
    out = mlstm_ops.mlstm_chunkwise(*leaves, chunk=chunk, return_state=state)
    outs = out if state else (out,)
    assert outs[0].grad_fn is not None
    seeds = [torch.randn(o.shape, device=cuda, generator=gen) for o in outs]
    torch.autograd.backward(outs, seeds)
    torch.cuda.synchronize()
    assert (ML.launches, ML.backward_launches) == (before[0] + 1,
                                                   before[1] + 1)
    plain = [t.clone().requires_grad_(True) for t in ins]
    ref = ML.mlstm_plain(*plain, chunk=chunk, return_state=state)
    want = torch.autograd.grad(ref if state else (ref,), plain, seeds)
    tol = 1e-3 if m >= 512 else 1e-4
    for t, w in zip(leaves, want):
        err = float((t.grad - w).abs().max())
        assert err <= tol * float(w.abs().max()), (err, float(w.abs().max()))


@pytest.mark.parametrize("B,S,H,m,chunk", [(1, 1024, 4, 512, 128),
                                           (1, 96, 1, 200, 48)])
def test_mlstm_backward_kernel_gives_the_same_bits_twice(cuda, B, S, H, m,
                                                         chunk):
    """Two calls of the backward kernel on the same inputs give the same
    bits (nothing is summed by atomics), seeds of the final state or
    not."""
    gen = torch.Generator(device=cuda).manual_seed(S + m)
    ins = [torch.randn(B, S, H, m, device=cuda, generator=gen)
           for _ in range(3)]
    ins += [torch.rand(B, S, H, device=cuda, generator=gen),
            -torch.rand(B, S, H, device=cuda, generator=gen)]
    with torch.no_grad():
        saved = ML.mlstm_kernel(*ins, chunk=chunk, save=True)
    dh = torch.randn(B, S, H, m, device=cuda, generator=gen)
    seeds = (torch.randn(B, H, m, m, device=cuda, generator=gen),
             torch.randn(B, H, m, device=cuda, generator=gen))
    for dc, dn in ((None, None), seeds):
        first = ML.mlstm_backward_kernel(*ins, *saved, dh, dc, dn,
                                         chunk=chunk)
        again = ML.mlstm_backward_kernel(*ins, *saved, dh, dc, dn,
                                         chunk=chunk)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_mlstm_backward_kernel_at_den_one_matches_plain(cuda):
    """At an exact tie |den| = 1 (q_0 = (sqrt(m), 0, ...), k_0 = (1, 0,
    ...), i_0 = 1 at batch 0, head 0) the kernel takes JAX's rule as
    ``mlstm_backward_plain`` does, half the gradient reaching den: each
    gradient within 1e-4 of its max of the plain version's on the same
    saved tensors, and off torch's whole-gradient rule at the tie."""
    B, S, H, m, chunk = 2, 64, 2, 16, 16
    gen = torch.Generator(device=cuda).manual_seed(41)
    q, k, v = (torch.randn(B, S, H, m, device=cuda, generator=gen)
               for _ in range(3))
    ig = torch.rand(B, S, H, device=cuda, generator=gen) * 0.9 + 0.05
    lf = -torch.rand(B, S, H, device=cuda, generator=gen)
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0] = math.sqrt(m)
    k[0, 0, 0] = 0.0
    k[0, 0, 0, 0] = 1.0
    ig[0, 0, 0] = 1.0
    ins = (q, k, v, ig, lf)
    with torch.no_grad():
        h, c_in, n_in, den = ML.mlstm_kernel(*ins, chunk=chunk, save=True)
    assert float(den[0, 0, 0]) == 1.0
    dh = torch.randn(B, S, H, m, device=cuda, generator=gen)
    got = ML.mlstm_backward_kernel(*ins, h, c_in, n_in, den, dh,
                                   chunk=chunk)
    want = ML.mlstm_backward_plain(*ins, h, c_in, n_in, den, dh,
                                   chunk=chunk)
    plain = [t.clone().requires_grad_(True) for t in ins]
    clamp = torch.autograd.grad(ML.mlstm_plain(*plain, chunk=chunk),
                                plain, dh)
    torch.cuda.synchronize()
    off = 0.0
    for g, w, t in zip(got, want, clamp):
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * top
        off = max(off, float((t - w).abs().max()) / top)
    assert off > 1e-3  # the tie changes the gradients


@pytest.mark.parametrize("B,S,D", [(2, 64, 200), (2, 65, 200),
                                   (1, 300, 512)])
def test_rg_lru_backward_kernel_bit_equal_to_plain(cuda, B, S, D):
    """``loss.backward()`` through ``rg_lru_scan`` on the card launches
    the backward kernel once: its gradients are ``rg_lru_backward_plain``'s
    bits on the forward's h_seq, the same at every ``block_lanes``, and
    within 1e-5 of autograd's through ``rg_lru_plain`` (nonzero h0 and
    dh_final)."""
    gen = torch.Generator(device=cuda).manual_seed(S + D)
    a = torch.rand(B, S, D, device=cuda, generator=gen)
    b, dhs = (torch.randn(B, S, D, device=cuda, generator=gen)
              for _ in range(2))
    h0, dhn = (torch.randn(B, D, device=cuda, generator=gen)
               for _ in range(2))
    got = None
    for lanes in (128, 256, 512):
        leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
        before = RL.backward_launches
        hs, hn = rg_ops.rg_lru_scan(*leaves, block_lanes=lanes)
        torch.autograd.backward((hs, hn), (dhs, dhn))
        torch.cuda.synchronize()
        assert RL.backward_launches == before + 1
        grads = [t.grad for t in leaves]
        if got is None:
            got = grads
            plain = RL.rg_lru_backward_plain(a, hs.detach(), h0, dhs, dhn)
            assert all(torch.equal(x, y) for x, y in zip(got, plain))
        assert all(torch.equal(x, y) for x, y in zip(grads, got)), lanes
    ref = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    want = torch.autograd.grad(RL.rg_lru_plain(*ref), ref, (dhs, dhn))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_recurrent_train_step_launches_backward_kernels(cuda):
    """One remat training step of each recurrent family at smoke size in
    float32 on the card: every mLSTM (RG-LRU) layer launches its forward
    kernel twice (the step and the recompute) and its backward kernel
    once, and the loss is finite."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.models.model_api import layer_kinds
    from repro_torch.tree import leaves, map_tree

    for arch, mod, kind in (("xlstm_350m", ML, "mlstm"),
                            ("recurrentgemma_2b", RL, "rec")):
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        model = build_model(cfg)
        params = map_tree(lambda t: t.to(cuda).requires_grad_(True),
                          model.init(torch.Generator().manual_seed(0)))
        batch = {k: torch.as_tensor(v, device=cuda) for k, v in
                 TokenPipeline(cfg, 2, 32, seed=0).batch_at(0).items()}
        before = (mod.launches, mod.backward_launches)
        loss = model.loss(params, batch, remat=True)
        loss.backward()
        torch.cuda.synchronize()
        layers = layer_kinds(cfg).count(kind)
        assert (mod.launches - before[0], mod.backward_launches - before[1]
                ) == (2 * layers, layers), arch
        assert math.isfinite(loss.item())
        assert all(p.grad is not None for p in leaves(params)), arch


@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-2b"])
def test_launch_train_trains_recurrent_families_on_cuda(cuda, arch,
                                                        tmp_path):
    """``python -m repro_torch.launch.train --arch ... --smoke`` trains the
    recurrent families on the card: finite losses, and the step's forward
    and backward kernels launched."""
    from repro_torch.launch import train as launch_train

    mod = ML if arch.startswith("xlstm") else RL
    before = (mod.launches, mod.backward_launches)
    rep = launch_train.main(["--arch", arch, "--smoke", "--steps", "3",
                             "--ckpt-dir", str(tmp_path / "ck")])
    assert rep["final_step"] == 3
    assert all(math.isfinite(m["loss"]) for m in rep["metrics"])
    assert mod.launches > before[0] and mod.backward_launches > before[1]
