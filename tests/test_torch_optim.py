"""``tests/test_optim.py`` on the port (``repro_torch.optim``), with
cross-package equalities, on the CPU.

Every case of the reference file runs on torch tensors with its own
asserts; where a value is computed, the JAX package computes it too and
the two agree: the schedule to 1 ulp of float32, AdamW trajectories to
``TOL`` = 1e-6, int8 codes and scales exactly (both round half to even).
Added: ``adamw_update`` on the reference's own stacked parameter tree of
a smoke model (its layer leaves carry the leading group axis, so the
per-layer norms are decayed and ``final_norm`` is not), and the port's
flat tree, whose per-layer norms (d,) are decayed all the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.optim.schedule import cosine_schedule as jcosine
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     decays)
from repro_torch.optim.compression import (compress_grads, decompress_grads,
                                           ef_compress_tree,
                                           init_compression_state)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import leaves, leaves_with_paths, map_tree

torch.set_num_threads(1)

TOL = 1e-6


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.3, weight_decay=0.0)
    jparams = {"w": jnp.array([5.0, -3.0])}
    jopt = JA.adamw_init(jparams)
    jcfg = JA.AdamWConfig(lr=0.3, weight_decay=0.0)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    for _ in range(100):
        w = params["w"].clone().requires_grad_(True)
        loss({"w": w}).backward()
        params, opt, _ = adamw_update(cfg, {"w": w.grad}, opt, params)
        jg = jax.grad(lambda p: jnp.sum(p["w"] ** 2))(jparams)
        jparams, jopt, _ = JA.adamw_update(jcfg, jg, jopt, jparams)
    assert float(loss(params)) < 1e-2
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]),
                               rtol=TOL, atol=TOL)
    assert int(opt["step"]) == int(jopt["step"]) == 100


def test_grad_clip_caps_update_norm():
    params = {"w": torch.ones((4,))}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=1e-3, grad_clip=1.0, weight_decay=0.0)
    g = {"w": torch.full((4,), 1e6)}
    new, _, metrics = adamw_update(cfg, g, opt, params)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    jnew, _, jmetrics = JA.adamw_update(
        JA.AdamWConfig(lr=1e-3, grad_clip=1.0, weight_decay=0.0),
        {"w": jnp.full((4,), 1e6)}, JA.adamw_init({"w": jnp.ones((4,))}),
        {"w": jnp.ones((4,))})
    assert float(metrics["grad_norm"]) == float(jmetrics["grad_norm"])
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=TOL, atol=TOL)


def test_schedule_warmup_and_decay():
    assert float(cosine_schedule(torch.tensor(0), warmup=10, total=100)) == 0.0
    assert float(cosine_schedule(torch.tensor(10), warmup=10, total=100)) \
        == pytest.approx(1.0)
    end = float(cosine_schedule(torch.tensor(100), warmup=10, total=100))
    assert end == pytest.approx(0.1, abs=1e-6)
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        got = float(cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                    warmup=10, total=100))
        want = float(jcosine(jnp.asarray(step, jnp.int32), warmup=10,
                             total=100))
        assert got == pytest.approx(want, rel=2 ** -23, abs=1e-12), step


def _check_compression_bounded_error(vals):
    g = torch.tensor(np.array(vals, np.float32))
    codes, scales = compress_grads(g)
    deq = decompress_grads(codes, scales, g.shape)
    blockmax = float(torch.max(torch.abs(g))) if g.numel() else 0.0
    assert float(torch.max(torch.abs(deq - g))) <= blockmax / 127.0 + 1e-6
    # the JAX package's codes and scales, exactly
    jcodes, jscales = JC.compress_grads(jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))


if HAVE_HYPOTHESIS:
    @settings(max_examples=30, deadline=None)
    @given(st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=1,
                    max_size=300))
    def test_compression_bounded_error(vals):
        _check_compression_bounded_error(vals)
else:
    def test_compression_bounded_error():
        pytest.importorskip("hypothesis")


def test_compression_bounded_error_fallback():
    """Deterministic coverage of the bounded-error property — always
    runs, so the core assertion holds even without hypothesis."""
    rng = np.random.default_rng(7)
    for size in (1, 3, 64, 300):
        _check_compression_bounded_error(
            (rng.uniform(-1e3, 1e3, size=size)).tolist())
    _check_compression_bounded_error([0.0, 0.0, 0.0])
    _check_compression_bounded_error([1e3, -1e3, 5e-7])


def test_error_feedback_converges():
    """With EF, the *accumulated* quantization error stays bounded and the
    mean compressed gradient tracks the true gradient."""
    w = (np.random.default_rng(0).normal(size=512).astype(np.float32) * 1e-3)
    g = {"w": torch.from_numpy(w)}
    state = init_compression_state(g)
    jg = {"w": jnp.asarray(w)}
    jstate = JC.init_compression_state(jg)
    total_sent = torch.zeros_like(g["w"])
    steps = 20
    for _ in range(steps):
        sent, state = ef_compress_tree(g, state)
        jsent, jstate = JC.ef_compress_tree(jg, jstate)
        np.testing.assert_allclose(sent["w"].numpy(), np.asarray(jsent["w"]),
                                   rtol=0, atol=TOL * 1e-3)
        total_sent = total_sent + sent["w"]
    # sum of transmitted grads ≈ steps * g (error feedback is unbiased)
    np.testing.assert_allclose(
        total_sent.numpy(), steps * w,
        atol=2 * float(np.max(np.abs(w))) / 127.0 + 1e-6)


# ------------------------------------------- the reference's stacked tree --
def _smoke_tree(arch="recurrentgemma_2b"):
    jcfg = dataclasses.replace(jget_config(arch).smoke(), dtype="float32")
    return jcfg, jbuild_model(jcfg).init(jax.random.key(0))


def test_adamw_update_on_reference_stacked_tree():
    """Two steps of ``adamw_update`` on the reference's own parameter tree
    (stacked layers: norms (G, d) decayed, ``final_norm`` (d,) not) from
    seeded gradients, against the JAX package's, leaf by leaf."""
    _, jparams = _smoke_tree()
    cfg = AdamWConfig()
    jcfg = JA.AdamWConfig()
    params = jax.tree.map(lambda a: t(a), jparams)
    rng = np.random.default_rng(1)
    jopt, opt = JA.adamw_init(jparams), adamw_init(params)
    for step in range(2):
        g_np = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            jparams)
        jparams, jopt, jm = JA.adamw_update(jcfg, g_np, jopt, jparams, 0.5)
        params, opt, m = adamw_update(cfg, jax.tree.map(t, g_np), opt,
                                      params, 0.5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
    jflat = [np.asarray(a) for a in jax.tree.leaves(jparams)]
    assert len(jflat) == len(leaves(params))
    for (path, got), want in zip(leaves_with_paths(params), jflat):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg="/".join(map(str, path)))
    for key in ("m", "v"):
        for got, want in zip(leaves(opt[key]), jax.tree.leaves(jopt[key])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
    # the stacked norms moved by decay, final_norm by the step alone
    assert params["stacks"][0]["b0"]["norm1"]["scale"].dim() == 2


def test_flat_tree_decays_as_the_stacked_one():
    """The port's flat tree takes the reference's decisions: every leaf
    of a layer (its norms (d,) too) and every matrix is decayed,
    ``final_norm`` is not; and one update of converted weights equals the
    reference's on its stacked tree."""
    arch = "recurrentgemma_2b"
    jcfg, jparams = _smoke_tree(arch)
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu", dtype=torch.float32)
    for path, p in leaves_with_paths(params):
        assert decays(path, p) == (path[0] in ("layers", "embed")), path
    assert not decays(("final_norm", "scale"), params["final_norm"]["scale"])

    rng = np.random.default_rng(2)
    g_np = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jparams)
    jnew, _, _ = JA.adamw_update(JA.AdamWConfig(lr=1e-2), g_np,
                                 JA.adamw_init(jparams), jparams)
    grads = params_from_jax(cfg, g_np, device="cpu", dtype=torch.float32)
    adamw_update(AdamWConfig(lr=1e-2), grads, adamw_init(params), params)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jnew), device="cpu",
                           dtype=torch.float32)
    map_tree(lambda a, b: np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=TOL, atol=TOL), params, want)
