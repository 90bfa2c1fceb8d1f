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
    (torch.zeros(2, (1 << 20) + 1, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 1 << 22, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 1, dtype=torch.complex64), ValueError),
    (torch.zeros(64, 2, dtype=torch.complex64).t(), ValueError),
    (torch.zeros(2, 64, dtype=torch.complex64, device="meta"), ValueError),
])
def test_fft_rejects(bad, exc):
    with pytest.raises(exc):
        tfft_ops.fft(bad)


# --------------------------------------------------- fft at any length ----
#: lengths that are not powers of two: Bluestein's algorithm over the
#: port's FFT and ZIP (inner lengths 8, 32, 2048, 4096 and 8192)
ANY_N = [3, 12, 1000, 1536, 4095]


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("rows", [1, 3], ids=["rows1", "rows3"])
@pytest.mark.parametrize("n", ANY_N)
def test_fft_any_length_matches_jnp_fft(n, rows, forward):
    """The JAX package's device op at these lengths is ``jnp.fft.fft``
    (``repro.apps.radar._jfft`` / ``_jifft``; its Pallas FFT takes powers
    of two only): the port's CPU path, Bluestein over the plain versions,
    agrees with it at the power-of-two tolerance, an inverse times n."""
    from repro.apps import radar as jradar

    x = crandn(np.random.default_rng([n, rows, forward]), rows, n)
    want = np.asarray(jradar._jfft(x) if forward else jradar._jifft(x))
    got = tfft_ops.fft(torch.from_numpy(x), forward=forward)
    assert got.dtype == torch.complex64 and got.shape == (rows, n)
    rtol, atol = fft_tol(n)
    s = 1 if forward else n
    np.testing.assert_allclose(got.numpy() * s, want * s, rtol=rtol,
                               atol=atol)


def test_bluestein_chirp_keeps_its_phase_at_the_longest_length():
    """The chirp's angle comes from k^2 mod 2N in int64: at N = 2^20 - 1
    every entry is within float32 rounding of the exact root (k^2 in
    float32 would be off by whole turns past k of a few thousand)."""
    from repro_torch.kernels.fft import bluestein as BL

    n = (1 << 20) - 1
    k = np.arange(n - 4096, n, dtype=np.int64)
    exact = np.exp(-1j * np.pi * ((k * k) % (2 * n)) / n)
    w = BL.chirp(n, False)
    assert w.dtype == np.complex64 and w.shape == (n,)
    assert np.max(np.abs(w[n - 4096:] - exact)) < 2 ** -23
    assert np.array_equal(BL.chirp(n, True), np.conj(w))


@pytest.mark.parametrize("n", [3, 1000, (1 << 19) + 1, (1 << 20) - 1])
def test_bluestein_inner_length_and_filter(n):
    """M is the least power of two >= 2N - 1 (2^21 above 2^19, which the
    kernel takes); the filter is conj(w) at m and M - m, zeros between,
    and the inverse's carries the 1/N."""
    from repro_torch.kernels.fft import bluestein as BL
    from repro_torch.kernels.fft import fft as F

    m = BL.inner_length(n)
    assert m & (m - 1) == 0 and m >= 2 * n - 1 and m // 2 < 2 * n - 1
    assert m <= F.MAX_POW2
    if n < 2000:
        for inverse in (False, True):
            b = BL.filter_taps(n, inverse)
            w = BL.chirp(n, inverse)
            scale = 1.0 / n if inverse else 1.0
            assert b.shape == (m,) and b.dtype == np.complex64
            np.testing.assert_allclose(b[:n], np.conj(w) * scale, rtol=0,
                                       atol=1e-7)
            np.testing.assert_allclose(b[m - n + 1:][::-1],
                                       np.conj(w[1:]) * scale, rtol=0,
                                       atol=1e-7)
            assert not b[n:m - n + 1].any()


@pytest.mark.parametrize("route", ["fused", "plain"])
def test_bluestein_launches_and_block_rows(monkeypatch, route):
    """fused: on the card one call is one call of the library's
    ``rimms_bluestein_c64`` (a stand-in here, so this runs on the CPU):
    one FFT launch count and no ZIP count, the launch structure of the
    caller's block_rows, no workspace up to M = 8192 and two buffers of
    rows x M above.  plain: a CPU tensor's composition is five steps over
    the plain versions (counted stand-ins): ZIP, the FFT of length M,
    ZIP, its inverse, ZIP."""
    from repro_torch.kernels.fft import bluestein as BL
    from repro_torch.kernels.fft import fft as F
    from repro_torch.kernels.zip import zip as Z

    x = torch.from_numpy(crandn(np.random.default_rng(7), 2, 1000))
    want = BL.bluestein_plain(x, inverse=False)
    calls = []
    if route == "plain":
        fft_plain, zip_plain = F.fft_plain, Z.zip_plain

        def fake_fft(a, *, inverse=False):
            calls.append(("fft", a.shape[-1], inverse))
            return fft_plain(a, inverse=inverse)

        def fake_zip(a, b):
            calls.append(("zip", a.shape))
            return zip_plain(a, b)

        monkeypatch.setattr(BL, "fft_plain", fake_fft)
        monkeypatch.setattr(BL, "zip_plain", fake_zip)
        got = BL.bluestein_plain(x, inverse=False)
        assert calls == [("zip", (2, 1000)), ("fft", 2048, False),
                         ("zip", (2, 2048)), ("fft", 2048, True),
                         ("zip", (2, 1000))]
        assert torch.equal(got, want)
        return

    made = []

    class Lib:
        rimms_bluestein_c64 = "bluestein"

    empty_like, new_empty = torch.empty_like, torch.Tensor.new_empty

    def spy_empty_like(t, *a, **k):
        made.append(empty_like(t, *a, **k))
        return made[-1]

    def spy_new_empty(t, *a, **k):
        made.append(new_empty(t, *a, **k))
        return made[-1]

    monkeypatch.setattr(torch, "empty_like", spy_empty_like)
    monkeypatch.setattr(torch.Tensor, "new_empty", spy_new_empty)
    monkeypatch.setattr(BL, "library", lambda: Lib)
    monkeypatch.setattr(BL, "launch",
                        lambda fn, t, *a: calls.append((fn, a)) or 0)
    for n in (1000, 5000):
        x = torch.from_numpy(crandn(np.random.default_rng(n), 2, n))
        BL.tables(n, False, "cpu")  # built before the counts are read
        del calls[:], made[:]
        counts = (F.launches, Z.launches)
        out = BL.bluestein_kernel(x, inverse=False, block_rows=32)
        assert (F.launches, Z.launches) == (counts[0] + 1, counts[1])
        (fn, (src, dst, work, addr)), = calls
        assert fn == "bluestein" and out is made[0]
        assert (src, dst) == (x.data_ptr(), out.data_ptr())
        assert out.shape == x.shape and out.dtype == x.dtype
        addr32, args, _ = BL._launch_args(-1, n, 2, 32, False)
        assert addr == addr32
        m = BL.inner_length(n)
        if m <= F.TABLE_N:
            assert work is None and len(made) == 1
            assert (args.threads, args.rows_per_group, args.groups_per_block,
                    args.grid, args.smem) == BL.launch_geometry(n, 2, 32)
        else:
            assert len(made) == 2 and work == made[1].data_ptr()
            assert made[1].shape == (4, m) and made[1].dtype == x.dtype


def test_bluestein_kernel_raises_on_a_refused_launch(monkeypatch):
    """A launch the library refuses raises; the call does not fall back
    to the composition and counts nothing."""
    from repro_torch.kernels.fft import bluestein as BL
    from repro_torch.kernels.fft import fft as F
    from repro_torch.kernels.zip import zip as Z

    class Lib:
        rimms_bluestein_c64 = "bluestein"

    def no(*a, **k):
        raise AssertionError("the composition ran")

    monkeypatch.setattr(BL, "library", lambda: Lib)
    monkeypatch.setattr(BL, "launch", lambda fn, t, *a: 1)
    monkeypatch.setattr(BL, "bluestein", no)
    monkeypatch.setattr(BL, "fft_kernel", no)
    x = torch.from_numpy(crandn(np.random.default_rng(3), 1, 1000))
    BL.tables(1000, True, "cpu")
    counts = (F.launches, Z.launches)
    with pytest.raises(RuntimeError, match="fft kernel launch failed"):
        BL.bluestein_kernel(x, inverse=True, block_rows=8)
    assert (F.launches, Z.launches) == counts


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
