"""The port's chunked RG-LRU scan and its mLSTM at xLSTM's head width,
against the JAX package's Pallas kernels and the sequential oracles.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
runs them on the CPU, and the port's ops take their plain torch versions
for CPU tensors.  Tolerances are the reference's: 1e-4 on the sweep and
1e-5 a step for the RG-LRU, 2e-3 for the mLSTM.  The sequence lengths
straddle the scan's chunk (``rg_lru.CHUNK``): one chunk, a chunk and a
step, ragged last chunks.
"""

import math

import numpy as np
import pytest
import torch

from repro.kernels.mlstm import ops as jmlstm
from repro.kernels.rg_lru import ops as jrg
from repro_torch.kernels.mlstm import ops as tmlstm
from repro_torch.kernels.mlstm import ref as tmlstm_ref
from repro_torch.kernels.rg_lru import ops as trg
from repro_torch.kernels.rg_lru import rg_lru as RL
from repro_torch.kernels.rg_lru import ref as trg_ref

torch.set_num_threads(1)

L = RL.CHUNK
RG_SHAPES = [(1, 1, 128), (2, L - 1, 200), (1, L, 128), (3, L + 1, 128),
             (1, 2 * L + 5, 256), (2, 3 * L, 200), (1, 5 * L - 3, 128)]


def rg_inputs(seed, B, S, D, lo=0.3, hi=0.999):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,D", RG_SHAPES)
def test_rg_lru_chunked_matches_pallas_and_oracle(B, S, D):
    a, b, h0 = rg_inputs(S + D, B, S, D)
    ts = [torch.from_numpy(x) for x in (a, b, h0)]
    hs, hn = trg.rg_lru_scan(*ts)
    ws, wn = jrg.rg_lru_scan(a, b, h0)
    rs, rn = trg_ref.rg_lru_scan(*ts)
    for got, want in ((hs, ws), (hn, wn), (hs, rs), (hn, rn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("S", [L - 3, L + 7, 3 * L + 1])
def test_rg_lru_chunked_matches_sequential_loop_each_step(S):
    """At the reference's per-step tolerance (1e-5) against the float32
    sequential loop, for the port and the Pallas kernel alike."""
    a, b, h0 = rg_inputs(S, 1, S, 128, 0.5, 0.9)
    hs, _ = trg.rg_lru_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    jhs, _ = jrg.rg_lru_scan(a, b, h0)
    h = h0.copy()
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(hs[:, t].numpy(), h, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(jhs[:, t]), h, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("B,S,D", [(2, L + 9, 512), (1, 3 * L, 200)])
def test_rg_lru_chunked_block_lanes_bit_identical(B, S, D):
    ts = [torch.from_numpy(x) for x in rg_inputs(D, B, S, D)]
    ref = trg.rg_lru_scan(*ts)
    for lanes in (256, 512, 1000):
        got = trg.rg_lru_scan(*ts, block_lanes=lanes)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def mlstm_inputs(seed, B, S, H, m):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, m)).astype(np.float32),
            (rng.normal(size=(B, S, H, m)) * 0.3).astype(np.float32),
            rng.normal(size=(B, S, H, m)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(B, S, H)).astype(np.float32),
            np.log(rng.uniform(0.5, 0.95, size=(B, S, H))).astype(np.float32))


@pytest.mark.parametrize("chunk", [32, 64])
def test_mlstm_xlstm_head_width_matches_pallas_and_oracle(chunk):
    """m 512 (xlstm-350m's head width) at a short sequence, against the
    Pallas kernel and the float64 sequential oracle at 2e-3."""
    B, S, H, m = 1, 128, 1, 512
    ins = mlstm_inputs(m + chunk, B, S, H, m)
    ts = [torch.from_numpy(x) for x in ins]
    got = tmlstm.mlstm_chunkwise(*ts, chunk=chunk)
    want = jmlstm.mlstm_chunkwise(*ins, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    q, k, v, ig, lf = ts

    def bh(x):
        return x.transpose(1, 2).reshape(B * H, S, -1)

    oracle = tmlstm_ref.mlstm_sequential(
        bh(q / math.sqrt(m)), bh(k), bh(v), bh(ig[..., None])[..., 0],
        bh(lf[..., None])[..., 0]).reshape(B, H, S, m).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-3,
                               atol=2e-3)
