"""The port's hand-written CUDA kernels and its main path on the card.

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
    # sums in another order than the plain version
    rtol = 3e-3 if n >= 2048 else 5e-4
    return rtol, rtol * math.sqrt(n)


@pytest.mark.parametrize("n", [2, 64, 512, 2048, 8192])
def test_fft_kernel_matches_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(3, n, dtype=torch.complex64, device=cuda, generator=gen)
    before = F.launches
    rtol, atol = fft_tol(n)
    for fwd in (True, False):
        got = fft_ops.fft(x, fwd)
        torch.testing.assert_close(got, F.fft_plain(x, inverse=not fwd),
                                   rtol=rtol, atol=atol)
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


@pytest.mark.parametrize("B,S,Hq,Hkv,d,bk,dtype,causal", [
    (2, 256, 4, 2, 64, 128, torch.float32, True),
    (1, 512, 2, 1, 128, 256, torch.float32, True),
    (2, 128, 4, 4, 64, 64, torch.bfloat16, True),
    (1, 384, 2, 2, 64, 128, torch.float32, True),
    (1, 300, 4, 1, 128, 100, torch.float32, False),
])
def test_flash_attention_kernel_matches_plain(cuda, B, S, Hq, Hkv, d, bk,
                                              dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(B, S, h, d, device=cuda, generator=gen).to(dtype)
               for h in (Hq, Hkv, Hkv))
    before = FA.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, block_k=bk)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(
        got.float(), FA.flash_attention_plain(
            q, k, v, causal=causal, block_k=min(bk, S)).float(),
        rtol=tol, atol=tol)
    for bq in (128, 512):
        assert torch.equal(got, flash_ops.flash_attention(
            q, k, v, causal=causal, block_q=bq, block_k=bk))
    assert FA.launches == before + 3


@pytest.mark.parametrize("B,S,D", [(2, 32, 128), (3, 64, 200), (1, 256, 2560)])
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
                                           (1, 256, 2, 512, 64)])
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
