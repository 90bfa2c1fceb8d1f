"""The port's flash-attention, mLSTM and RG-LRU ops against the JAX
package's Pallas kernels.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs the Pallas kernels in interpret mode, exactly as
``tests/test_kernels.py`` runs them on the CPU; the port's side runs the
plain torch versions, which is what its ops take for a CPU tensor.  The
shapes and tolerances are those of ``tests/test_kernels.py``.  The
hand-written CUDA kernels are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jflash
from repro.kernels.mlstm import ops as jmlstm
from repro.kernels.rg_lru import ops as jrg
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.flash_attention import ref as tflash_ref
from repro_torch.kernels.mlstm import ops as tmlstm
from repro_torch.kernels.mlstm import ref as tmlstm_ref
from repro_torch.kernels.rg_lru import ops as trg
from repro_torch.kernels.rg_lru import ref as trg_ref

torch.set_num_threads(1)


def both(x, dtype="f32"):
    """One numpy array as (JAX array, torch CPU tensor) of one dtype."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------ flash attention ----
FLASH_SWEEP = [
    (2, 256, 4, 2, 64, 128, 128, "f32"),
    (1, 512, 2, 1, 128, 128, 256, "f32"),
    (2, 128, 4, 4, 64, 64, 64, "bf16"),
    (1, 384, 2, 2, 64, 128, 128, "f32"),  # ragged block count
]


def flash_inputs(seed, B, S, Hq, Hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, d)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, d)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, d)).astype(np.float32))


@pytest.mark.parametrize("B,S,Hq,Hkv,d,bq,bk,dtype", FLASH_SWEEP)
def test_flash_attention_plain_matches_pallas(B, S, Hq, Hkv, d, bq, bk,
                                              dtype):
    q, k, v = flash_inputs(S + Hq, B, S, Hq, Hkv, d)
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in (q, k, v))
    want = jflash.flash_attention(jq, jk, jv, block_q=bq, block_k=bk)
    got = tflash.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)
    assert got.dtype == tq.dtype and got.shape == (B, S, Hq, d)
    tol = 2e-2 if dtype == "bf16" else 2e-4
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,d,bq,bk,dtype", FLASH_SWEEP)
def test_flash_attention_plain_matches_dense_oracle(B, S, Hq, Hkv, d, bq, bk,
                                                    dtype):
    q, k, v = flash_inputs(S + d, B, S, Hq, Hkv, d)
    tq, tk, tv = (both(x, dtype)[1] for x in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)
    rep = Hq // Hkv

    def to_bh(x):
        return x.transpose(1, 2).reshape(B * Hq, S, d)

    want = tflash_ref.attention(
        to_bh(tq), to_bh(tk.repeat_interleave(rep, dim=2)),
        to_bh(tv.repeat_interleave(rep, dim=2)))
    want = want.reshape(B, Hq, S, d).transpose(1, 2)
    tol = 2e-2 if dtype == "bf16" else 2e-4
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 96, 256])
def test_flash_attention_any_head_width_matches_pallas(d, dtype):
    """Head widths the kernel runs at a padded compiled width (32 at 64,
    96 at 128, 256 at its own): the port against the reference's Pallas
    kernel in interpret mode at (1, 256, 2, d), causal, the softmax
    scale that of the true d."""
    q, k, v = flash_inputs(d, 1, 256, 2, 2, d)
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in (q, k, v))
    want = jflash.flash_attention(jq, jk, jv, block_q=128, block_k=128)
    got = tflash.flash_attention(tq, tk, tv, block_q=128, block_k=128)
    assert got.dtype == tq.dtype and got.shape == (1, 256, 2, d)
    tol = 2e-2 if dtype == "bf16" else 2e-4
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def test_flash_attention_padded_widths():
    from repro_torch.kernels.flash_attention import flash_attention as FA

    assert [FA.padded_width(d) for d in (1, 32, 64, 65, 80, 96, 128, 129,
                                         192, 193, 256)] == [
        64, 64, 64, 128, 128, 128, 128, 192, 192, 256, 256]


def test_flash_attention_non_causal_matches_pallas():
    q, k, v = flash_inputs(7, 1, 128, 2, 2, 64)
    (jq, tq), (jk, tk), (jv, tv) = (both(x) for x in (q, k, v))
    want = jflash.flash_attention(jq, jk, jv, causal=False, block_q=64,
                                  block_k=64)
    got = tflash.flash_attention(tq, tk, tv, causal=False, block_q=64,
                                 block_k=64)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_ragged_key_tile(causal):
    """block_k that does not divide S: the last key tile is narrower and
    no column past S enters the softmax."""
    q, k, v = flash_inputs(11, 1, 300, 4, 1, 128)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, causal=causal, block_k=128)
    rep = 4

    def to_bh(x):
        return x.transpose(1, 2).reshape(4, 300, 128)

    want = tflash_ref.attention(
        to_bh(tq), to_bh(tk.repeat_interleave(rep, dim=2)),
        to_bh(tv.repeat_interleave(rep, dim=2)), causal=causal)
    np.testing.assert_allclose(
        got.numpy(), want.reshape(1, 4, 300, 128).transpose(1, 2).numpy(),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_block_q_bit_identical(causal, dtype):
    """The autotuner's block_q candidates (128, 256, 512) are pure launch
    parameters: bit-identical output."""
    q, k, v = flash_inputs(3, 1, 512, 4, 2, 64)
    tq, tk, tv = (both(x, dtype)[1] for x in (q, k, v))
    outs = [tflash.flash_attention(tq, tk, tv, causal=causal, block_q=bq)
            for bq in (256, 128, 512)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


# --------------------------------------------------------------- rg_lru ----
def rg_inputs(seed, B, S, D, lo=0.3, hi=0.999):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,D", [(2, 32, 128), (3, 64, 200), (1, 128, 256)])
def test_rg_lru_plain_matches_pallas(B, S, D):
    a, b, h0 = rg_inputs(D, B, S, D)
    ws, wn = jrg.rg_lru_scan(a, b, h0)
    hs, hn = trg.rg_lru_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert hs.shape == (B, S, D) and hn.shape == (B, D)
    np.testing.assert_allclose(hs.numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hn.numpy(), np.asarray(wn), rtol=1e-4,
                               atol=1e-4)
    rs, rn = trg_ref.rg_lru_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    np.testing.assert_allclose(hs.numpy(), rs.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hn.numpy(), rn.numpy(), rtol=1e-4, atol=1e-4)


def test_rg_lru_matches_sequential_loop():
    a, b, _ = rg_inputs(16, 1, 16, 128, 0.5, 0.9)
    h0 = np.zeros((1, 128), np.float32)
    hs, _ = trg.rg_lru_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    jhs, _ = jrg.rg_lru_scan(a, b, h0)
    h = np.zeros((1, 128), np.float32)
    for t in range(16):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(hs[:, t].numpy(), h, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(jhs[:, t]), h, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("D", [512, 200])
def test_rg_lru_block_lanes_bit_identical(D):
    a, b, h0 = rg_inputs(5, 2, 48, D)
    ts = [torch.from_numpy(x) for x in (a, b, h0)]
    ref = trg.rg_lru_scan(*ts)
    for lanes in (256, 512, 1000):
        got = trg.rg_lru_scan(*ts, block_lanes=lanes)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_rg_lru_block_lanes_clamp_matches_reference():
    from repro_torch.kernels.rg_lru.ops import _clamp_lanes

    for d in (128, 200, 512, 2560):
        dp = d + (-d) % 128
        for lanes in (128, 200, 256, 300, 512, 1024, 4096):
            want = max(lane for lane in range(128, min(lanes, dp) + 1, 128)
                       if dp % lane == 0)
            assert _clamp_lanes(lanes, d) == want


# ---------------------------------------------------------------- mlstm ----
def mlstm_inputs(seed, B, S, H, m):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, m)).astype(np.float32)
    k = (rng.normal(size=(B, S, H, m)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, S, H, m)).astype(np.float32)
    ig = rng.uniform(0.1, 0.9, size=(B, S, H)).astype(np.float32)
    lf = np.log(rng.uniform(0.5, 0.95, size=(B, S, H))).astype(np.float32)
    return q, k, v, ig, lf


MLSTM_SWEEP = [(2, 64, 2, 128, 16), (1, 32, 4, 64, 8), (1, 128, 1, 128, 64)]


@pytest.mark.parametrize("B,S,H,m,chunk", MLSTM_SWEEP)
def test_mlstm_plain_matches_pallas(B, S, H, m, chunk):
    ins = mlstm_inputs(S + m, B, S, H, m)
    want = jmlstm.mlstm_chunkwise(*ins, chunk=chunk)
    got = tmlstm.mlstm_chunkwise(*(torch.from_numpy(x) for x in ins),
                                 chunk=chunk)
    assert got.shape == (B, S, H, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("B,S,H,m,chunk", MLSTM_SWEEP)
def test_mlstm_plain_matches_sequential_oracle(B, S, H, m, chunk):
    q, k, v, ig, lf = (torch.from_numpy(x)
                       for x in mlstm_inputs(S * H, B, S, H, m))
    got = tmlstm.mlstm_chunkwise(q, k, v, ig, lf, chunk=chunk)

    def to_bh(x):
        return x.transpose(1, 2).reshape(B * H, S, m)

    def g_bh(x):
        return x.transpose(1, 2).reshape(B * H, S)

    want = tmlstm_ref.mlstm_sequential(
        to_bh(q / math.sqrt(m)), to_bh(k), to_bh(v), g_bh(ig), g_bh(lf)
    ).reshape(B, H, S, m).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("B,S,H,m", [(1, 512, 1, 32), (1, 256, 2, 64)])
def test_mlstm_plain_matches_pallas_at_chunk_256(B, S, H, m):
    """The reference's ``rec_chunk`` of 256, which the kernel takes in
    row blocks of 128: the port's chunkwise recurrence at chunk 256
    against the reference's Pallas kernel in interpret mode, at
    tests/test_kernels.py's tolerance."""
    ins = mlstm_inputs(S + m + 256, B, S, H, m)
    want = jmlstm.mlstm_chunkwise(*ins, chunk=256)
    got = tmlstm.mlstm_chunkwise(*(torch.from_numpy(x) for x in ins),
                                 chunk=256)
    assert got.shape == (B, S, H, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_mlstm_chunk_variants_agree_but_not_bit_identical():
    """The reference marks ``chunk`` not bit-identical
    (``Tunable(bit_identical=False)``): chunk sizes change the order of
    accumulation.  In both packages the candidates agree to rounding and
    differ in bits."""
    from repro.core.autotune import tunables as jtunables
    from repro_torch.core.autotune import tunables

    assert [t.bit_identical for t in tunables() if t.op == "mlstm"] == [False]
    assert [t.bit_identical for t in jtunables() if t.op == "mlstm"] == [False]
    ins = mlstm_inputs(9, 1, 128, 2, 64)
    ts = [torch.from_numpy(x) for x in ins]
    outs = {c: tmlstm.mlstm_chunkwise(*ts, chunk=c) for c in (32, 64, 128)}
    jouts = {c: np.asarray(jmlstm.mlstm_chunkwise(*ins, chunk=c))
             for c in (32, 64)}
    assert outs[32].numpy().tobytes() != outs[64].numpy().tobytes()
    assert jouts[32].tobytes() != jouts[64].tobytes()
    for c in (32, 128):
        np.testing.assert_allclose(outs[c].numpy(), outs[64].numpy(),
                                   rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------- rejects ----
def test_flash_attention_rejects():
    q, k, v = (torch.from_numpy(x) for x in flash_inputs(1, 1, 64, 4, 2, 64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tflash.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="dtypes differ"):
        tflash.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="multiple of"):
        tflash.flash_attention(q[:, :, :3].contiguous(), k, v)
    wide = [torch.zeros(*t.shape[:3], 257) for t in (q, k, v)]
    with pytest.raises(ValueError, match="head width"):
        tflash.flash_attention(*wide)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="block_q"):
        tflash.flash_attention(q, k, v, block_q=0)
    m = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tflash.flash_attention(*m)


def test_mlstm_rejects():
    ts = [torch.from_numpy(x) for x in mlstm_inputs(2, 1, 96, 2, 64)]
    with pytest.raises(ValueError, match="does not divide"):
        tmlstm.mlstm_chunkwise(*ts, chunk=64)
    with pytest.raises(TypeError, match="float32"):
        tmlstm.mlstm_chunkwise(*[t.double() for t in ts], chunk=32)
    with pytest.raises(ValueError, match="shape"):
        tmlstm.mlstm_chunkwise(*ts[:3], ts[3][:, :, :1].contiguous(), ts[4],
                               chunk=32)
    z, g = torch.zeros(1, 512, 1, 8), torch.zeros(1, 512, 1)
    with pytest.raises(ValueError, match="larger than 256"):
        tmlstm.mlstm_chunkwise(z, z, z, g, g, chunk=512)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tmlstm.mlstm_chunkwise(*[t.to("meta") for t in ts], chunk=32)


def test_rg_lru_rejects():
    ts = [torch.from_numpy(x) for x in rg_inputs(3, 1, 8, 128)]
    with pytest.raises(ValueError, match="block_lanes 64"):
        trg.rg_lru_scan(*ts, block_lanes=64)
    with pytest.raises(TypeError, match="float32"):
        trg.rg_lru_scan(*[t.to(torch.bfloat16) for t in ts])
    with pytest.raises(ValueError, match="h0"):
        trg.rg_lru_scan(ts[0], ts[1], ts[2][:, :64].contiguous())
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trg.rg_lru_scan(*[t.to("meta") for t in ts])
