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

from repro_torch.apps import radar
from repro_torch.kernels.fft import fft as F
from repro_torch.kernels.fft import ops as fft_ops
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
