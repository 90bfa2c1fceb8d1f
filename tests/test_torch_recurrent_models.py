"""The port's recurrent families (``ssm``: xlstm-350m, ``hybrid``:
recurrentgemma-2b) against the JAX package, on the CPU.

Inputs are made with numpy from a seed; weights are the JAX package's,
carried across by ``params_from_jax``.  The port's layers reach
``mlstm_chunkwise`` and ``rg_lru_scan``, whose plain versions run for a
CPU tensor; the reference's layers run their own chunkwise einsums and
``associative_scan``.  Covered: each recurrent layer in prefill and
decode (outputs and every cache leaf), both models' logits in float32
and bfloat16 (the multi-stack plan too), the ports of
``tests/test_models_smoke.py``'s decode and prefill↔decode cases, the
chunk the kernel is clamped to, the mLSTM op's final state, the stack
plans, the held dtypes and the families with JAX blocked.
``test_models_smoke.py``'s loss and train-step cases, for every family,
are in ``tests/test_torch_models_smoke.py``.

Tolerances:

* ``F32_TOL`` = 1e-4 (rtol and atol), a layer or a model in float32:
  the same math, summed in another order (a chunked scan against an
  associative scan, another matmul order).
* ``CONSISTENCY_TOL`` = 2e-3, prefill↔decode: the reference's own bound
  for chunkwise against stepwise math and for two chunk sizes
  (``tests/test_models_smoke.py``).
* bfloat16 logits within ``BF16_ULPS`` = 8 ulps of the largest reference
  logit: the two frameworks round at other points (XLA keeps a fused
  elementwise chain's intermediates in float32, eager torch rounds after
  every op), a few ulps through a few layers.
"""

import dataclasses
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import recurrent as JR
from repro.models.model_api import stack_plan as jstack_plan
from repro_torch.configs import get_config
from repro_torch.kernels.mlstm import mlstm as ML
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.rg_lru import rg_lru as RL
from repro_torch.models import build_model, stack_plan
from repro_torch.models import recurrent as TR
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model_api import BLOCKS, layer_kinds

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
F32_TOL = 1e-4
CONSISTENCY_TOL = 2e-3
BF16_ULPS = 8
ARCHS = ("xlstm_350m", "recurrentgemma_2b")


def cfgs(arch, dtype="float32", **kw):
    """(port config, JAX config): the arch's smoke config in ``dtype``."""
    return (dataclasses.replace(get_config(arch).smoke(), dtype=dtype, **kw),
            dataclasses.replace(jget_config(arch).smoke(), dtype=dtype, **kw))


def to_torch(tree):
    """A JAX parameter or cache tree as torch CPU tensors of the same
    dtype (float32, or bfloat16 for a bfloat16 leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = to_torch(v)
            continue
        t = torch.from_numpy(np.asarray(v, np.float32).copy())
        out[k] = t.bfloat16() if v.dtype == jnp.bfloat16 else t
    return out


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_tree_close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), (what, k)
        np.testing.assert_allclose(as_np(got[k]), as_np(want[k]), rtol=tol,
                                   atol=tol, err_msg=f"{what}: {k}")


def assert_bf16_close(got, want, what):
    want = as_np(want)
    top = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    err = float(np.abs(as_np(got) - want).max())
    assert err <= BF16_ULPS * ulp, (
        f"{what}: max |err| {err} > {BF16_ULPS} ulps of {top} ({ulp})")


# ------------------------------------------------------------- layers ----
LAYERS = [("xlstm_350m", "MLSTMLayer"), ("xlstm_350m", "SLSTMLayer"),
          ("recurrentgemma_2b", "RGLRULayer")]


@pytest.mark.parametrize("arch,layer", LAYERS)
def test_layer_prefill_and_decode_match_reference(arch, layer):
    """Output and every cache leaf (mLSTM C, n, conv; sLSTM c, h, n;
    RG-LRU h, conv) after a prefill of 24 tokens (three of the smoke
    config's 8-token chunks) and after two decode steps from it."""
    cfg, jcfg = cfgs(arch)
    jl, tl = getattr(JR, layer), getattr(TR, layer)
    jp = jl.init(jcfg, jax.random.key(5))
    tp = to_torch(jp)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    jy, jc = jl.apply(jcfg, jp, jnp.asarray(x), mode="prefill")
    ty, tc = tl.apply(cfg, tp, torch.from_numpy(x), mode="prefill")
    np.testing.assert_allclose(as_np(ty), as_np(jy), rtol=F32_TOL,
                               atol=F32_TOL)
    assert_tree_close(tc, jc, F32_TOL, f"{layer} prefill cache")
    for pos in (24, 25):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jpos = jnp.full((2,), pos, jnp.int32)
        jy, jc = jl.apply(jcfg, jp, jnp.asarray(x1), mode="decode",
                          cache=jc, pos=jpos)
        ty, tc = tl.apply(cfg, tp, torch.from_numpy(x1), mode="decode",
                          cache=tc, pos=torch.full((2,), pos))
        np.testing.assert_allclose(as_np(ty), as_np(jy), rtol=F32_TOL,
                                   atol=F32_TOL)
        assert_tree_close(tc, jc, F32_TOL, f"{layer} decode cache at {pos}")


def test_mlstm_prefill_at_the_reference_chunk_of_256():
    """The full configs' ``rec_chunk`` 256: at S 512 the port's prefill
    runs chunk 256, as the reference does, and the layer's output and
    prefill cache agree with the reference's ``MLSTMLayer.apply`` at the
    float32 tolerance of the other layer tests."""
    cfg, jcfg = cfgs("xlstm_350m", rec_chunk=256)
    assert TR.MLSTMLayer.prefill_chunk(cfg, 512) == 256 == ML.MAX_CHUNK
    jp = JR.MLSTMLayer.init(jcfg, jax.random.key(6))
    tp = to_torch(jp)
    x = np.random.default_rng(8).normal(
        size=(1, 512, cfg.d_model)).astype(np.float32)
    jy, jc = JR.MLSTMLayer.apply(jcfg, jp, jnp.asarray(x), mode="prefill")
    ty, tc = TR.MLSTMLayer.apply(cfg, tp, torch.from_numpy(x),
                                 mode="prefill")
    np.testing.assert_allclose(as_np(ty), as_np(jy), rtol=F32_TOL,
                               atol=F32_TOL)
    assert_tree_close(tc, jc, F32_TOL, "chunk 256 cache")


def test_mlstm_op_state_is_the_reference_layers_final_state():
    """``mlstm_chunkwise(return_state=True)`` on the layer's own inputs
    gives the reference layer's Cs[-1], ns[-1] (its prefill cache), in
    its orientation C[a, e] = Σ w k_a v_e; h is the same bits with and
    without the state, and a call counts no launch on the CPU."""
    cfg, jcfg = cfgs("xlstm_350m")
    jp = JR.MLSTMLayer.init(jcfg, jax.random.key(9))
    tp = to_torch(jp)
    x = np.random.default_rng(10).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32)
    _, jc = JR.MLSTMLayer.apply(jcfg, jp, jnp.asarray(x), mode="prefill")
    ins = TR.MLSTMLayer.kernel_inputs(cfg, tp, torch.from_numpy(x))
    chunk = TR.MLSTMLayer.prefill_chunk(cfg, 40)
    before = ML.launches
    h, C, n = mlstm_ops.mlstm_chunkwise(*ins, chunk=chunk, return_state=True)
    assert ML.launches == before
    M, H, m = TR.MLSTMLayer._dims(cfg)
    assert C.shape == (2, H, m, m) and n.shape == (2, H, m)
    np.testing.assert_allclose(C.numpy(), as_np(jc["C"]), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(n.numpy(), as_np(jc["n"]), rtol=F32_TOL,
                               atol=F32_TOL)
    assert torch.equal(h, mlstm_ops.mlstm_chunkwise(*ins, chunk=chunk))
    # an empty sequence leaves the zero state
    empty = [t[:, :0].contiguous() for t in ins]
    h0, C0, n0 = mlstm_ops.mlstm_chunkwise(*empty, return_state=True)
    assert h0.shape == (2, 0, H, m)
    assert not C0.any() and not n0.any() and C0.shape == C.shape


def test_kernel_inputs_are_what_prefill_hands_the_kernels():
    """``kernel_inputs`` gives the tensors a prefill passes the ops:
    contiguous float32, q unscaled (the op divides it by √m)."""
    cfg, _ = cfgs("xlstm_350m", dtype="bfloat16")
    params = build_model(cfg).init(torch.Generator().manual_seed(3))
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4)).bfloat16()
    seen = {}
    orig_m, orig_r = mlstm_ops.mlstm_chunkwise, TR.rg_lru_ops.rg_lru_scan

    def grab(name, fn):
        def call(*args, **kw):
            seen[name] = args
            return fn(*args, **kw)
        return call

    mlstm_ops.mlstm_chunkwise = grab("mlstm", orig_m)
    TR.rg_lru_ops.rg_lru_scan = grab("rg_lru", orig_r)
    try:
        TR.MLSTMLayer.apply(cfg, params["layers"][0], x, mode="prefill")
        rcfg, _ = cfgs("recurrentgemma_2b", dtype="bfloat16")
        rparams = build_model(rcfg).init(torch.Generator().manual_seed(5))
        xr = torch.randn(2, 16, rcfg.d_model).bfloat16()
        TR.RGLRULayer.apply(rcfg, rparams["layers"][0], xr, mode="prefill")
    finally:
        mlstm_ops.mlstm_chunkwise, TR.rg_lru_ops.rg_lru_scan = orig_m, orig_r
    want_m = TR.MLSTMLayer.kernel_inputs(cfg, params["layers"][0], x)
    want_r = TR.RGLRULayer.kernel_inputs(rcfg, rparams["layers"][0], xr)
    for got, want in ((seen["mlstm"], want_m), (seen["rg_lru"][:2], want_r)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.is_contiguous()
            assert torch.equal(g, w)
    assert not seen["rg_lru"][2].any()  # h0 = 0


# -------------------------------------------------------------- models ----
def jax_and_port(arch, dtype, seed=1, **kw):
    cfg, jcfg = cfgs(arch, dtype, **kw)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    return cfg, build_model(cfg), params, jmodel, jparams


def run_both(arch, dtype, **kw):
    """Prefill of two 24-token prompts, then three greedy decode steps,
    in both packages on the same weights: the logits of each call."""
    cfg, model, params, jmodel, jparams = jax_and_port(arch, dtype, **kw)
    toks = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(2, 24)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_len=40)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_len=40)
    out = [(tl, jl)]
    tok = np.array([3, 8], np.int32)
    for pos in (24, 25, 26):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok),
                                    jnp.full((2,), pos, jnp.int32))
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok),
                                   torch.full((2,), pos, dtype=torch.int32))
        out.append((tl, jl))
        tok = as_np(jl).argmax(-1).astype(np.int32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference_f32(arch):
    for tl, jl in run_both(arch, "float32"):
        np.testing.assert_allclose(as_np(tl), as_np(jl), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference_bf16(arch):
    for i, (tl, jl) in enumerate(run_both(arch, "bfloat16")):
        assert tl.dtype == torch.bfloat16
        assert_bf16_close(tl, jl, f"{arch} call {i}")


def test_multi_stack_plan_carried_across():
    """recurrentgemma at 8 layers: two groups of (rec, rec, attn) and a
    second stack (rec, rec) — the tree is flattened group by group, then
    by position in the pattern, as the reference runs it."""
    cfg, jcfg = cfgs("recurrentgemma_2b", n_layers=8)
    assert stack_plan(cfg) == jstack_plan(jcfg) == [
        (("rec", "rec", "attn"), 2), (("rec", "rec"), 1)]
    assert layer_kinds(cfg) == ["rec", "rec", "attn"] * 2 + ["rec", "rec"]
    for tl, jl in run_both("recurrentgemma_2b", "float32", n_layers=8):
        np.testing.assert_allclose(as_np(tl), as_np(jl), rtol=F32_TOL,
                                   atol=F32_TOL)


# ------------------------- ports of tests/test_models_smoke.py's cases ----
@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    cfg = get_config(request.param).smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    return request.param, cfg, model, params


def test_decode_step_shapes_and_finite(arch_setup):
    aid, cfg, model, params = arch_setup
    B, max_len = 2, 64
    caches = model.init_cache(B, max_len, device=CPU)
    tok = torch.tensor([1, 2], dtype=torch.int32)
    pos = torch.tensor([5, 5], dtype=torch.int32)
    logits, caches = model.decode_step(params, caches, tok, pos)
    assert logits.shape == (B, cfg.vocab)
    assert torch.isfinite(logits.float()).all(), aid


def test_prefill_decode_consistency(arch_setup):
    """next-token logits after prefill(prompt[:-1]) + decode(prompt[-1])
    must match prefill(prompt): the chunked kernels' state against the
    stepwise decode math.  The reference's shape (prefill_32k smoke: 2 ×
    32) and bound; 31 tokens make the mLSTM chunk 1."""
    aid, cfg, _, _ = arch_setup
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0))
    shape = jbase.SHAPES["prefill_32k"].smoke()
    B, S = shape.global_batch, shape.seq_len
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32))
    full_logits, _ = model.prefill(params, {"tokens": toks}, max_len=S + 8)
    logits1, caches = model.prefill(params, {"tokens": toks[:, :-1]},
                                    max_len=S + 8)
    logits2, _ = model.decode_step(params, caches, toks[:, -1],
                                   torch.full((B,), S - 1, dtype=torch.int32))
    np.testing.assert_allclose(logits2.numpy(), full_logits.numpy(),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


# ------------------------------------------------- plans, dtypes, JAX ----
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_stack_plan_matches_reference(arch):
    cfg = get_config(arch)
    assert stack_plan(cfg) == jstack_plan(jget_config(arch))
    assert stack_plan(cfg.smoke()) == jstack_plan(jget_config(arch).smoke())
    assert len(layer_kinds(cfg)) == cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_init_holds_weights_in_compute_dtype(arch):
    """bfloat16 everywhere but the leaves the reference reads in float32
    at every use (``FLOAT32``: the sLSTM's r_gates and b_gates, the
    RG-LRU's lam), which stay float32; one dict per layer, of its
    kind's leaves."""
    cfg = get_config(arch).smoke()  # bf16
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert len(params["layers"]) == cfg.n_layers
    kinds = layer_kinds(cfg)
    for kind, layer in zip(kinds, params["layers"]):
        block = BLOCKS[kind]
        ref = block.init(cfg, torch.Generator().manual_seed(0))
        assert sorted(layer) == sorted(ref)
        for name, leaf in layer.items():
            leaves = leaf.values() if isinstance(leaf, dict) else [leaf]
            want = (torch.float32 if name in block.FLOAT32
                    else torch.bfloat16)
            assert all(t.dtype == want for t in leaves), (kind, name)
    for t in (params["embed"]["table"], params["final_norm"]["scale"]):
        assert t.dtype == torch.bfloat16


def test_cpu_tensors_never_reach_the_kernels():
    before = (ML.launches, RL.launches)
    run_both("recurrentgemma_2b", "float32")
    cfg = get_config("xlstm_350m").smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    model.prefill(params, {"tokens": torch.tensor([[1, 2, 3, 4]])},
                  max_len=8)
    assert (ML.launches, RL.launches) == before


def test_recurrent_families_run_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import dataclasses, torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        for arch in ("xlstm_350m", "recurrentgemma_2b"):
            cfg = dataclasses.replace(get_config(arch).smoke(),
                                      dtype="float32")
            model = build_model(cfg)
            params = model.init(torch.Generator().manual_seed(0))
            logits, caches = model.prefill(
                params, {"tokens": torch.tensor([[1, 2, 3, 4, 5]])},
                max_len=16)
            logits, caches = model.decode_step(
                params, caches, torch.tensor([6]), torch.tensor([5]))
            assert torch.isfinite(logits).all()
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
