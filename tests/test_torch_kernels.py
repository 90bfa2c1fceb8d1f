"""The port's FFT and ZIP ops against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs the Pallas kernels in interpret mode, exactly as
``tests/test_kernels.py`` runs them on the CPU; the port's side runs the
plain torch versions, which is what its ops take for a CPU tensor.  The
hand-written CUDA kernels are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from repro.kernels.fft import ops as jfft_ops
from repro.kernels.zip import ops as jzip_ops
from repro_torch.kernels.fft import ops as tfft_ops
from repro_torch.kernels.fft import ref as tfft_ref
from repro_torch.kernels.zip import ops as tzip_ops

torch.set_num_threads(1)


def crandn(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def fft_tol(n):
    # The tolerances of tests/test_kernels.py: f32 twiddles, and the two
    # sides sum in different orders (the Pallas kernel takes cos/sin of a
    # rounded f32 angle, the port sin/cos of the exact fraction 2k/m).
    # They are sized for forward outputs (about sqrt(n)); an inverse
    # (about 1/sqrt(n)) is compared times n (fft_scale).
    rtol = 3e-3 if n >= 2048 else 5e-4
    return rtol, rtol * n ** 0.5


def fft_scale(n, forward):
    # n for an inverse: a power of two, so the scaling is exact
    return 1 if forward else n


# ---------------------------------------------------------------- fft ----
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("rows", [4, 3], ids=["rows4", "ragged3"])
@pytest.mark.parametrize("n", [2, 8, 64, 256, 1024, 2048])
def test_fft_plain_matches_pallas(n, rows, forward):
    x = crandn(np.random.default_rng([n, rows]), rows, n)
    want = np.asarray(jfft_ops.fft(x, forward=forward))
    got = tfft_ops.fft(torch.from_numpy(x), forward=forward)
    assert got.dtype == torch.complex64 and got.shape == (rows, n)
    rtol, atol = fft_tol(n)
    s = fft_scale(n, forward)
    np.testing.assert_allclose(got.numpy() * s, want * s, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("n", [2, 64, 8192])
def test_fft_plain_matches_torch_fft(n):
    x = torch.from_numpy(crandn(np.random.default_rng(n), 2, n))
    rtol, atol = fft_tol(n)
    for fwd in (True, False):
        s = fft_scale(n, fwd)
        torch.testing.assert_close(tfft_ops.fft(x, fwd) * s,
                                   tfft_ref.fft(x, fwd) * s,
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("rows", [1, 3], ids=["rows1", "ragged3"])
@pytest.mark.parametrize("n", [16384, 32768])
def test_fft_large_n_matches_pallas(n, rows, forward):
    """N past one launch on the card (the four-step passes there): the
    CPU path against the JAX package's Pallas kernel in interpret mode,
    as tests/test_kernels.py runs it, at its tolerance."""
    x = crandn(np.random.default_rng([n, rows, forward]), rows, n)
    want = np.asarray(jfft_ops.fft(x, forward=forward))
    got = tfft_ops.fft(torch.from_numpy(x), forward=forward)
    assert got.dtype == torch.complex64 and got.shape == (rows, n)
    rtol, atol = fft_tol(n)
    s = fft_scale(n, forward)
    np.testing.assert_allclose(got.numpy() * s, want * s, rtol=rtol,
                               atol=atol)


def test_fft_keeps_leading_shape_and_leaves_input():
    base = torch.from_numpy(crandn(np.random.default_rng(1), 4 * 64))
    view = base[64:192].reshape(2, 64)  # a fragment-like view at an offset
    before = base.clone()
    out = tfft_ops.fft(view)
    assert out.shape == (2, 64) and out.data_ptr() != view.data_ptr()
    assert torch.equal(base, before)
    torch.testing.assert_close(out, tfft_ref.fft(view), rtol=5e-4,
                               atol=5e-4 * 8)


def test_fft_block_rows_bit_identical():
    x = torch.from_numpy(crandn(np.random.default_rng(2), 5, 128))
    outs = [tfft_ops.fft(x, block_rows=b) for b in (8, 32, 128)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros(2, 64, dtype=torch.complex128), TypeError),
    (torch.zeros(2, 64, dtype=torch.float32), TypeError),
    (torch.zeros(2, 48, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 1 << 21, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 1, dtype=torch.complex64), ValueError),
    (torch.zeros(64, 2, dtype=torch.complex64).t(), ValueError),
    (torch.zeros(2, 64, dtype=torch.complex64, device="meta"), ValueError),
])
def test_fft_rejects(bad, exc):
    with pytest.raises(exc):
        tfft_ops.fft(bad)


# ---------------------------------------------------------------- zip ----
@pytest.mark.parametrize("shape", [(64,), (3, 300), (2, 5, 129)])
def test_zip_plain_matches_pallas(shape):
    rng = np.random.default_rng(len(shape))
    a, b = crandn(rng, *shape), crandn(rng, *shape)
    want = np.asarray(jzip_ops.zip_mul(a, b))
    got = tzip_ops.zip_mul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_zip_block_rows_bit_identical():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(crandn(rng, 3, 300))
    b = torch.from_numpy(crandn(rng, 3, 300))
    outs = [tzip_ops.zip_mul(a, b, block_rows=r) for r in (256, 1024, 4096)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("a,b,exc", [
    (torch.zeros(8, dtype=torch.complex128),
     torch.zeros(8, dtype=torch.complex128), TypeError),
    (torch.zeros(8, dtype=torch.complex64),
     torch.zeros(9, dtype=torch.complex64), ValueError),
    (torch.zeros(8, 2, dtype=torch.complex64).t(),
     torch.zeros(2, 8, dtype=torch.complex64), ValueError),
    (torch.zeros(8, dtype=torch.complex64, device="meta"),
     torch.zeros(8, dtype=torch.complex64, device="meta"), ValueError),
])
def test_zip_rejects(a, b, exc):
    with pytest.raises(exc):
        tzip_ops.zip_mul(a, b)
