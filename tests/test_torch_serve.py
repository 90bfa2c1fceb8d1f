"""The port's dense serving slice against the JAX package, on the CPU:
configs, model layers, ``Model.prefill``/``decode_step`` logits, and the
token streams of ``ServeEngine`` and ``SessionServeEngine`` on the
workloads of tests/test_serve_engine.py and tests/test_session_engine.py
— the same JAX weights carried across by ``params_from_jax``.  Plus the
port's own bit identities (session = legacy, spill = no spill, also in
bfloat16 through int16 raw-bit groups), the launcher, the example and
``benchmarks_torch/bench_serve.py``'s gate."""

import dataclasses
import json
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
from repro.models import layers as JL
from repro.models.model_api import stack_plan as jstack_plan
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.session_engine import SessionServeEngine as JSessionEngine
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import paged_attention as PA
from repro_torch.models import build_model, stack_plan
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.session_engine import SessionServeEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def smoke_cfg(arch="llama3_8b", **kw):
    return dataclasses.replace(get_config(arch).smoke(), dtype="float32",
                               **kw)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_config("llama3_8b").smoke(),
                               dtype="float32")
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.key(1))
    cfg = smoke_cfg()
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    return cfg, build_model(cfg), params, jcfg, jmodel, jparams


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_config(arch).smoke()) == \
        dataclasses.asdict(jget_config(arch).smoke())
    assert tbase.cells_for(arch) == jbase.cells_for(arch)


def test_get_config_accepts_dashed_names():
    assert get_config("llama3-8b") == get_config("llama3_8b")


def test_unported_families_raise():
    """Every family is ported now, with the reference's plans: MoE and
    audio (the encoder outside the plan, as in the reference) beside the
    dense, VLM and recurrent ones."""
    assert stack_plan(get_config("granite_moe_3b_a800m")) == [(("moe",), 32)]
    assert stack_plan(get_config("whisper_large_v3")) == [(("cross",), 32)]
    for arch in ("granite_moe_3b_a800m", "qwen3_moe_235b_a22b",
                 "whisper_large_v3"):
        assert stack_plan(get_config(arch)) == \
            jstack_plan(jget_config(arch))
    assert stack_plan(get_config("internvl2_26b")) == [(("dense",), 48)]
    assert stack_plan(get_config("xlstm_350m")) == [(("mlstm", "slstm"), 12)]
    assert stack_plan(get_config("recurrentgemma_2b")) == [
        (("rec", "rec", "attn"), 8), (("rec", "rec"), 1)]
    for arch in ("xlstm_350m", "recurrentgemma_2b"):
        assert stack_plan(get_config(arch)) == \
            jstack_plan(jget_config(arch))


# ----------------------------------------------------------------- layers --
def test_rope_freqs_are_float64_numpy():
    for hd, theta in ((128, 500_000.0), (16, 10_000.0)):
        np.testing.assert_array_equal(L.rope_freqs(hd, theta),
                                      JL.rope_freqs(hd, theta))


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    cfg = smoke_cfg(rope_theta=500_000.0)
    x = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    pos = np.arange(24)[None, :]
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     cfg.rope_theta).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 cfg.rope_theta)), rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(h), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(h), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        L.layer_norm(torch.from_numpy(h), torch.from_numpy(w),
                     torch.from_numpy(b)).numpy(),
        np.asarray(JL.layer_norm(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(b))), rtol=1e-5, atol=1e-5)


def test_rms_norm_casts_where_the_reference_does_in_bf16():
    """Normalised in f32, cast to bf16, then multiplied by the bf16
    weight: in bf16 the cast points decide the bits."""
    rng = np.random.default_rng(1)
    h = rng.normal(size=(4, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    got = L.rms_norm(torch.from_numpy(h).bfloat16(),
                     torch.from_numpy(w).bfloat16()).float().numpy()
    want = np.asarray(JL.rms_norm(jnp.asarray(h, jnp.bfloat16),
                                  jnp.asarray(w)).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    """``jax.nn.gelu`` is the tanh approximation by default."""
    rng = np.random.default_rng(2)
    cfg = smoke_cfg(act=act)
    jcfg = dataclasses.replace(jget_config("llama3_8b").smoke(),
                               dtype="float32", act=act)
    jparams = JL.mlp_init(jcfg, jax.random.key(3))
    tparams = {k: torch.from_numpy(np.asarray(v).copy())
               for k, v in jparams.items()}
    if act == "gelu":
        tparams["b_in"] = torch.from_numpy(
            rng.normal(size=tparams["b_in"].shape).astype(np.float32))
        jparams = dict(jparams, b_in=jnp.asarray(tparams["b_in"].numpy()))
    x = rng.normal(size=(3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        L.mlp_apply(cfg, tparams, torch.from_numpy(x)).numpy(),
        np.asarray(JL.mlp_apply(cfg, jparams, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 8, 16])  # 16: the local branch
def test_full_and_decode_attention_match_reference(window):
    rng = np.random.default_rng(4)
    cfg = smoke_cfg(window=window)
    jcfg = dataclasses.replace(jget_config("llama3_8b").smoke(),
                               dtype="float32", window=window)
    B, S, hd = 2, 32, 16
    q = rng.normal(size=(B, S, 4, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, 2, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, 2, hd)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(L.full_attention(cfg, *t).numpy(),
                               np.asarray(JL.full_attention(jcfg, *j)),
                               rtol=1e-5, atol=1e-5)
    kv_len = np.array([5, 32], np.int32)
    np.testing.assert_allclose(
        L.decode_attention(cfg, t[0][:, :1], t[1], t[2],
                           torch.from_numpy(kv_len)).numpy(),
        np.asarray(JL.decode_attention(jcfg, j[0][:, :1], j[1], j[2],
                                       jnp.asarray(kv_len))),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ model --
def test_prefill_and_decode_logits_match_reference(setup):
    cfg, model, params, _, jmodel, jparams = setup
    toks = np.array([[5, 9, 2, 7, 11, 3], [1, 2, 3, 4, 5, 6]], np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_len=16)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    tok = np.array([3, 8], np.int32)
    for pos in (6, 7, 8):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok),
                                    jnp.full((2,), pos, jnp.int32))
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok),
                                   torch.full((2,), pos, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


def test_vlm_prefill_matches_reference():
    jcfg = dataclasses.replace(jget_config("internvl2_26b").smoke(),
                               dtype="float32")
    cfg = smoke_cfg("internvl2_26b")
    jparams = jbuild_model(jcfg).init(jax.random.key(2))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    rng = np.random.default_rng(9)
    toks = rng.integers(1, cfg.vocab, size=(2, 5)).astype(np.int32)
    patches = rng.normal(size=(2, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    jl, _ = jbuild_model(jcfg).prefill(
        jparams, {"tokens": jnp.asarray(toks),
                  "patch_embeds": jnp.asarray(patches)}, max_len=16)
    tl, _ = build_model(cfg).prefill(
        params, {"tokens": torch.from_numpy(toks),
                 "patch_embeds": torch.from_numpy(patches)}, max_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_init_holds_weights_in_compute_dtype():
    cfg = dataclasses.replace(get_config("llama3_8b").smoke())  # bf16
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert len(params["layers"]) == cfg.n_layers
    leaves = [params["embed"]["table"], params["embed"]["head"],
              params["final_norm"]["scale"]]
    for layer in params["layers"]:
        for sub in layer.values():
            leaves += list(sub.values())
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    wq = params["layers"][0]["attn"]["wq"].float()
    assert wq.abs().max() <= 1.0 / np.sqrt(cfg.d_model)
    assert torch.equal(params["final_norm"]["scale"].float(),
                       torch.ones(cfg.d_model))


# ---------------------------------------------------- ServeEngine vs JAX --
def jax_legacy_tokens(jcfg, jparams, work, max_batch=3, **kw):
    eng = JServeEngine(jcfg, jparams, max_batch=max_batch, page_size=8,
                       num_pages=64, max_pages_per_seq=8, **kw)
    reqs = [eng.submit(p, m) for p, m in work]
    eng.run()
    return [r.generated for r in reqs]


def legacy_tokens(cfg, params, work, max_batch=3, **kw):
    eng = ServeEngine(cfg, params, max_batch=max_batch, page_size=8,
                      num_pages=64, max_pages_per_seq=8, device=CPU, **kw)
    reqs = [eng.submit(p, m) for p, m in work]
    eng.run()
    return [r.generated for r in reqs]


def make_work(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, vocab, int(rng.integers(2, 7)))],
             int(rng.integers(2, 6)))
            for _ in range(n)]


def test_engine_matches_jax_engine_and_dense_path(setup):
    cfg, model, params, jcfg, _, jparams = setup
    prompt, n_new = [5, 9, 2, 7], 6
    kw = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=16)
    jeng = JServeEngine(jcfg, jparams, **kw)
    jreq = jeng.submit(prompt, max_new_tokens=n_new)
    jeng.run()
    eng = ServeEngine(cfg, params, device=CPU, **kw)
    req = eng.submit(prompt, max_new_tokens=n_new)
    eng.run()
    assert req.done and req.generated == jreq.generated
    # the port's own dense path (prefill + decode_step) agrees too
    logits, caches = model.prefill(
        params, {"tokens": torch.tensor([prompt])}, max_len=128)
    tok, pos, want = int(torch.argmax(logits[0])), len(prompt), []
    for _ in range(n_new):
        want.append(tok)
        logits, caches = model.decode_step(params, caches, torch.tensor([tok]),
                                           torch.tensor([pos]))
        tok, pos = int(torch.argmax(logits[0])), pos + 1
    assert req.generated == want
    # every step counted: prompt[:-1] prefill steps + n_new decode steps
    assert eng.decode_steps == len(prompt) - 1 + n_new


def test_engine_batched_requests_and_page_recycling(setup):
    cfg, _, params, jcfg, _, jparams = setup
    kw = dict(max_batch=2, page_size=8, num_pages=32, max_pages_per_seq=8)
    work = [([i + 1, i + 2, i + 3], 4) for i in range(5)]
    jeng = JServeEngine(jcfg, jparams, **kw)
    want = [jeng.submit(p, m) for p, m in work]
    jeng.run()
    eng = ServeEngine(cfg, params, device=CPU, **kw)
    free0 = eng.pool.free_pages
    reqs = [eng.submit(p, m) for p, m in work]
    eng.run()
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    assert eng.pool.free_pages == free0
    assert [r.generated for r in reqs] == [r.generated for r in want]


# ---------------------------------------------- SessionServeEngine vs JAX --
def test_session_engine_matches_jax_multi_tenant(setup):
    cfg, _, params, jcfg, _, jparams = setup
    work = make_work(cfg.vocab)
    want = jax_legacy_tokens(jcfg, jparams, work)
    assert legacy_tokens(cfg, params, work) == want
    kw = dict(max_batch=3, page_size=8, num_pages=64, max_pages_per_seq=8,
              pages_per_group=8)
    with JSessionEngine(jcfg, jparams, **kw) as jeng:
        jreqs = [jeng.submit(p, m, tenant=["a", "b"][i % 2])
                 for i, (p, m) in enumerate(work)]
        jeng.run()
        jsteps = len(jeng.session.runtime.task_log)
    with SessionServeEngine(cfg, params, device=CPU, **kw) as eng:
        reqs = [eng.submit(p, m, tenant=["a", "b"][i % 2])
                for i, (p, m) in enumerate(work)]
        eng.run()
        assert all(r.done for r in reqs)
        assert [r.generated for r in reqs] == want
        assert [r.generated for r in jreqs] == want
        assert eng.kv.used_pages == 1  # scratch page only
        rep = eng.qos_report()
        assert {"a", "b", "prefill"} <= set(rep["latency_percentiles"])
        # the same tasks, and every decode step of each counted
        log = eng.session.runtime.task_log
        assert len(log) == jsteps
        n_decode = sum(name.startswith("llm_decode") for name, _ in log)
        n_prefill = sum(len(p) - 1 for p, _ in work if len(p) > 1)
        assert eng.decode_steps == n_decode + n_prefill


def test_close_releases_an_owned_sessions_workers(setup):
    """An engine that made its own session shuts that session's worker
    pool on ``close()``: no worker thread is left, and nothing keeps the
    engine (and through it the model's weights) alive."""
    import gc
    import weakref

    cfg, _, params, *_ = setup
    eng = SessionServeEngine(cfg, params, device=CPU, max_batch=2,
                             page_size=8, num_pages=32, max_pages_per_seq=4,
                             pages_per_group=8)
    req = eng.submit([1, 2, 3], 2)
    eng.run()
    assert req.done
    pool = eng.session.runtime._worker_pool
    threads = list(pool._threads)
    assert threads and all(t.is_alive() for t in threads)
    eng.close()
    for t in threads:
        t.join(timeout=10)
    assert pool.closed and not any(t.is_alive() for t in threads)
    assert eng.session.closed and eng.session.runtime._worker_pool is None
    alive = weakref.ref(eng)
    del eng, req
    gc.collect()
    assert alive() is None


def test_spill_under_pressure_matches_jax(setup):
    cfg, _, params, jcfg, _, jparams = setup
    rng = np.random.default_rng(7)
    work = [([int(t) for t in rng.integers(1, cfg.vocab,
                                           int(rng.integers(1, 9)))],
             int(rng.integers(1, 7)))
            for _ in range(28)]
    want = jax_legacy_tokens(jcfg, jparams, work, allocator="nextfit",
                             max_batch=4)
    with SessionServeEngine(cfg, params, max_batch=4, page_size=8,
                            num_pages=64, max_pages_per_seq=8,
                            pages_per_group=4, allocator="nextfit",
                            arena_bytes=150_000, device=CPU) as eng:
        reqs = [eng.submit(p, m, tenant=["a", "b"][i % 2])
                for i, (p, m) in enumerate(work)]
        eng.run()
        assert eng.kv.spill_bytes() > 0
        assert [r.generated for r in reqs] == want


def test_quota_defers_without_blocking_others(setup):
    cfg, _, params, *_ = setup
    work = make_work(cfg.vocab, n=4, seed=2)
    with SessionServeEngine(cfg, params, max_batch=4, page_size=8,
                            num_pages=64, max_pages_per_seq=8,
                            pages_per_group=8, device=CPU) as eng:
        eng.tenant("capped", quota_pages=2)
        reqs = [eng.submit(p, m, tenant="capped") for p, m in work[:3]]
        other = eng.submit(*work[3], tenant="open")
        eng.run()
        assert all(r.done for r in reqs) and other.done
        assert int(eng.session.metrics.counter(
            "serve_quota_deferrals").value) > 0
        assert eng.kv.pool.tenant_pages("capped") == 0
    assert [r.generated for r in reqs + [other]] == \
        legacy_tokens(cfg, params, work, max_batch=4)


def test_pool_exhaustion_backpressure_matches_jax(setup):
    cfg, _, params, jcfg, _, jparams = setup
    rng = np.random.default_rng(4)
    work = [([int(t) for t in rng.integers(1, cfg.vocab, 10)], 4)
            for _ in range(6)]
    want = jax_legacy_tokens(jcfg, jparams, work)
    with SessionServeEngine(cfg, params, max_batch=4, page_size=8,
                            num_pages=8, max_pages_per_seq=8,
                            pages_per_group=4, device=CPU) as eng:
        reqs = [eng.submit(p, m) for p, m in work]
        eng.run()
        assert all(r.done for r in reqs)
        assert [r.generated for r in reqs] == want
        assert int(eng.session.metrics.counter(
            "serve_pool_backpressure").value) > 0


def test_eos_mid_page_matches_jax(setup):
    cfg, _, params, jcfg, _, jparams = setup
    work = make_work(cfg.vocab, n=3, seed=0)
    eos = jax_legacy_tokens(jcfg, jparams, work)[0][0]
    long_work = [(p, 6) for p, _ in work]
    want = jax_legacy_tokens(jcfg, jparams, long_work, eos_id=eos)
    assert any(len(t) < 6 for t in want), "eos never fired; bad probe"
    assert legacy_tokens(cfg, params, long_work, eos_id=eos) == want
    with SessionServeEngine(cfg, params, max_batch=3, page_size=8,
                            num_pages=64, max_pages_per_seq=8,
                            pages_per_group=8, eos_id=eos, device=CPU) as eng:
        reqs = [eng.submit(p, m) for p, m in long_work]
        eng.run()
        assert [r.generated for r in reqs] == want
        assert eng.kv.used_pages == 1


def test_prompt_longer_than_max_pages_rejected(setup):
    cfg, _, params, *_ = setup
    long_prompt = list(range(1, 40))
    for ctor in (
        lambda: ServeEngine(cfg, params, page_size=8, num_pages=64,
                            max_pages_per_seq=2, device=CPU),
        lambda: SessionServeEngine(cfg, params, page_size=8, num_pages=64,
                                   max_pages_per_seq=2, device=CPU),
    ):
        eng = ctor()
        with pytest.raises(ValueError, match="max_pages_per_seq"):
            eng.submit(long_prompt, max_new_tokens=4)
        if isinstance(eng, SessionServeEngine):
            eng.close()


def test_serving_metrics_and_slo_exported(setup):
    cfg, _, params, *_ = setup
    work = make_work(cfg.vocab, n=3, seed=1)
    with SessionServeEngine(cfg, params, max_batch=3, page_size=8,
                            num_pages=64, max_pages_per_seq=8,
                            pages_per_group=8, device=CPU) as eng:
        eng.tenant("t0", slo_latency_s=60.0, slo_target=0.99)
        reqs = [eng.submit(p, m, tenant="t0") for p, m in work]
        eng.run()
        total = sum(len(r.generated) for r in reqs)
        m = eng.session.metrics
        assert int(m.counter("serve_tokens_generated").value) == total
        assert int(m.counter("serve_requests_completed").value) == len(work)
        text = eng.session.metrics_text()
        for name in ("serve_tokens_generated", "serve_requests_completed",
                     "serve_kv_pages_resident", "serve_kv_spill_bytes"):
            assert name in text
        slo = eng.qos_report()["slo"]["t0"]
        assert slo["violations"] == 0 and not slo["breached"]


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_engines_reject_recurrent_families(setup, family):
    cfg, _, params, *_ = setup
    bad = dataclasses.replace(cfg, family=family)
    with pytest.raises(ValueError, match="dense"):
        ServeEngine(bad, params, device=CPU)
    with pytest.raises(ValueError, match="dense"):
        SessionServeEngine(bad, params, device=CPU)


def test_engines_demand_cuda_by_default(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    cfg, _, params, *_ = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionServeEngine(cfg, params)


# ------------------------------------------------ the port's own identities --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_session_equals_legacy_and_spill_equals_no_spill(dtype):
    """Port-internal bit identity, in f32 and in bf16 (whose KV groups
    travel as int16 raw bits, through eviction and re-staging too)."""
    cfg = dataclasses.replace(get_config("llama3_8b").smoke(), dtype=dtype)
    params = build_model(cfg).init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(7)
    work = [([int(t) for t in rng.integers(1, cfg.vocab,
                                           int(rng.integers(1, 9)))],
             int(rng.integers(1, 7)))
            for _ in range(28)]
    want = legacy_tokens(cfg, params, work, allocator="nextfit", max_batch=4)
    runs = {}
    for arena in (64 << 20, 75_000 if dtype == "bfloat16" else 150_000):
        with SessionServeEngine(cfg, params, max_batch=4, page_size=8,
                                num_pages=64, max_pages_per_seq=8,
                                pages_per_group=4, allocator="nextfit",
                                arena_bytes=arena, device=CPU) as eng:
            if dtype == "bfloat16":
                assert eng.kv.k_bufs[0].dtype == np.int16
            reqs = [eng.submit(p, m, tenant=["a", "b"][i % 2])
                    for i, (p, m) in enumerate(work)]
            eng.run()
            runs[arena] = ([r.generated for r in reqs], eng.kv.spill_bytes())
    (big, spill0), (small, spill1) = runs.values()
    assert spill0 == 0 and spill1 > 0
    assert big == want and small == want


def test_cpu_tensors_never_reach_the_kernel(setup):
    cfg, _, params, *_ = setup
    before = PA.launches
    legacy_tokens(cfg, params, make_work(cfg.vocab, n=2))
    assert PA.launches == before


# ------------------------------------------ launcher, example, benchmark --
def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--requests", "3", "--max-new", "2"], device=CPU)
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "pool free 511/512" in out


def test_example_session_equals_legacy(capsys):
    sys.path.insert(0, str(ROOT / "examples_torch"))
    try:
        import serve_llm
    finally:
        sys.path.pop(0)
    session = serve_llm.main(["--tokens", "4"], device=CPU)
    legacy = serve_llm.main(["--legacy", "--tokens", "4"], device=CPU)
    assert [r.generated for r in session] == [r.generated for r in legacy]
    out = capsys.readouterr().out
    assert "tenant pro" in out and "kv spill bytes: 0" in out
    assert "served 8 requests / 32 tokens on the legacy engine" in out


def test_bench_serve_smoke_gate_equals_baseline():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks_torch import bench_serve
    finally:
        sys.path.pop(0)
    rec = bench_serve.run_serve(n_users=bench_serve.N_USERS, reqs_per_user=1,
                                json_path=None, smoke=True, device=CPU)
    base = json.loads(
        (ROOT / "benchmarks" / "baselines" / "BENCH_serve.json").read_text())
    assert rec["gate"] == base["gate"]
    assert rec["bit_identical_vs_legacy"] and rec["bit_identical_under_pressure"]


def test_serving_runs_with_jax_blocked():
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
        from repro_torch.serve.session_engine import SessionServeEngine
        cfg = dataclasses.replace(get_config("llama3_8b").smoke(),
                                  dtype="float32")
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        with SessionServeEngine(cfg, params, page_size=8, num_pages=32,
                                max_pages_per_seq=4, device="cpu") as eng:
            reqs = [eng.submit([1, 2, 3], 3), eng.submit([4, 5], 2)]
            eng.run()
        assert all(r.done for r in reqs)
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
