"""``tests/test_models_smoke.py`` on the port, for all ten archs, with
cross-package equalities, on the CPU.

Every case of the reference file runs here on the port's own weights
(``Model.init`` from a seeded generator) at the reference's config
(bfloat16 compute) with the reference's asserts.  Each then adds an
equality against the JAX package on the JAX package's weights, carried
across by ``params_from_jax``, in float32 compute (the two frameworks
round bf16 at other points: XLA keeps a fused chain's intermediates in
float32, eager torch rounds after every op):

* ``test_forward_loss_finite``: ``Model.loss`` within ``LOSS_TOL`` = 1e-5
  relative;
* ``test_train_step_updates_params``: one train step (``microbatches=2``,
  remat on) from the same weights and batch: loss and grad norm within
  ``STEP_TOL`` = 1e-4 relative, and every updated leaf within 1e-4 of
  its value plus 1e-4 of the leaf's largest value.  The key bias ``bk``
  (qwen1.5's ``qkv_bias``) is the exception, held to 1 % of one step
  (``NOISE_STEP``): its exact gradient is 0 (softmax is invariant to a
  shift of a query's scores), so both packages step it by
  ``lr · g / (|g| + eps)`` of a rounding-noise ``g``;
* ``test_decode_step_shapes_and_finite`` and
  ``test_prefill_decode_consistency``: the logits within ``F32_TOL`` =
  1e-4 of the JAX package's (the reference's own 2e-3 bound holds
  between prefill and decode);
* ``test_param_counts_sane``: ``param_counts`` exactly the JAX package's.

Batches come from numpy (``TokenPipeline.batch_at``, the same arrays to
both packages) at the reference's smoke shapes: train_4k and prefill_32k
smoke, 2 × 32 tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train.step import build_train_step as jbuild_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.step import build_train_step
from repro_torch.tree import leaves, leaves_with_paths

torch.set_num_threads(1)

CPU = "cpu"
LOSS_TOL = 1e-5
STEP_TOL = 1e-4
F32_TOL = 1e-4
CONSISTENCY_TOL = 2e-3
NOISE_STEP = 1e-2
#: leaves whose exact gradient is zero (module docstring)
ZERO_GRAD = ("bk",)


def numpy_batch(cfg, shape, seed=0):
    """The batch of ``shape`` (smoke) for ``cfg``, as numpy arrays:
    tokens and labels (vocab-range int32), plus patch embeddings (VLM) or
    frames (audio), from ``TokenPipeline``'s seeded generator; prefill
    shapes drop the labels."""
    batch = TokenPipeline(cfg, shape.global_batch, shape.seq_len,
                          seed=seed).batch_at(0)
    if shape.kind == "prefill":
        batch.pop("labels")
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch_setup(request):
    """(arch, port smoke cfg, port model, port params from its own init,
    the JAX package's float32 model and params for the equalities)."""
    aid = request.param
    cfg = get_config(aid).smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    jcfg32 = dataclasses.replace(jget_config(aid).smoke(), dtype="float32")
    jmodel32 = jbuild_model(jcfg32)
    jparams = jmodel32.init(jax.random.key(0))
    return aid, cfg, model, params, jmodel32, jparams


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def converted(cfg, jparams, dtype=None):
    return params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                           device=CPU, dtype=dtype)


def test_forward_loss_finite(arch_setup):
    aid, cfg, model, params, jmodel32, jparams = arch_setup
    batch = numpy_batch(cfg, SHAPES["train_4k"].smoke())
    loss = model.loss(params, to_torch(batch), remat=False)
    assert np.isfinite(float(loss)), aid
    assert float(loss) > 0
    # float32 against the JAX package on its weights
    cfg32 = f32(cfg)
    got = build_model(cfg32).loss(converted(cfg32, jparams), to_torch(batch),
                                  remat=False)
    want = jmodel32.loss(jparams, to_jax(batch), remat=False)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL,
                               atol=0, err_msg=aid)


def test_train_step_updates_params(arch_setup):
    aid, cfg, model, _, jmodel32, jparams = arch_setup
    batch = numpy_batch(cfg, SHAPES["train_4k"].smoke())
    step = build_train_step(model, remat=True, microbatches=2)
    # float32 master weights, bf16 compute
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    before = [p.clone() for p in leaves(params)]
    opt = adamw_init(params)
    new_params, new_opt, metrics = step(params, opt, to_torch(batch))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new_opt["step"]) == 1
    # at least one leaf moved
    moved = any(not torch.allclose(a, b)
                for a, b in zip(before, leaves(new_params)))
    assert moved, aid

    # float32 against the JAX package: one step from the same weights
    cfg32 = f32(cfg)
    jstep = jax.jit(jbuild_train_step(jmodel32, remat=True, microbatches=2))
    jnew, jopt, jmetrics = jstep(jparams, jadamw_init(jparams),
                                 to_jax(batch))
    params = converted(cfg32, jparams, torch.float32)
    step32 = build_train_step(build_model(cfg32), remat=True, microbatches=2)
    new_params, new_opt, metrics = step32(params, adamw_init(params),
                                          to_torch(batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=STEP_TOL, atol=0,
                                   err_msg=f"{aid} {key}")
    assert int(new_opt["step"]) == int(jopt["step"]) == 1
    want = converted(cfg32, jnew, torch.float32)
    lr = float(metrics["lr"])
    for (path, got), w in zip(leaves_with_paths(new_params), leaves(want)):
        what = f"{aid} {'/'.join(map(str, path))}"
        if path[-1] in ZERO_GRAD:
            err = float((got - w).abs().max())
            assert err <= NOISE_STEP * lr, (what, err, lr)
            continue
        np.testing.assert_allclose(
            got.numpy(), w.numpy(), rtol=STEP_TOL,
            atol=STEP_TOL * float(w.abs().max()), err_msg=what)


def test_decode_step_shapes_and_finite(arch_setup):
    aid, cfg, model, params, jmodel32, jparams = arch_setup
    B, max_len = 2, 64
    caches = model.init_cache(B, max_len, device=CPU)
    tok = torch.tensor([1, 2], dtype=torch.int32)
    pos = torch.tensor([5, 5], dtype=torch.int32)
    logits, caches = model.decode_step(params, caches, tok, pos)
    assert logits.shape == (B, cfg.vocab)
    assert torch.isfinite(logits.float()).all(), aid
    # float32 against the JAX package from zero caches
    cfg32 = f32(cfg)
    m32 = build_model(cfg32)
    got, _ = m32.decode_step(converted(cfg32, jparams),
                             m32.init_cache(B, max_len, device=CPU), tok, pos)
    want, _ = jmodel32.decode_step(jparams, jmodel32.init_cache(B, max_len),
                                   jnp.asarray(tok.numpy()),
                                   jnp.asarray(pos.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL, err_msg=aid)


def test_prefill_decode_consistency(arch_setup):
    """next-token logits after prefill(prompt[:-1]) + decode(prompt[-1])
    must match prefill(prompt) — exercises KV/state handoff (the encoder's
    keys and values too, for audio)."""
    aid, cfg, _, _, jmodel32, jparams = arch_setup
    cfg32 = f32(cfg)
    model = build_model(cfg32)
    params = converted(cfg32, jparams)
    batch = numpy_batch(cfg32, SHAPES["prefill_32k"].smoke())
    B, S = batch["tokens"].shape
    full_logits, _ = model.prefill(params, to_torch(batch), max_len=S + 8)

    b1 = dict(batch)
    b1["tokens"] = batch["tokens"][:, :-1]
    logits1, caches = model.prefill(params, to_torch(b1), max_len=S + 8)
    # sequence position of the final token (VLM: patches prefix the seq)
    pos_last = S - 1 + (cfg.n_patches if cfg.family == "vlm" else 0)
    logits2, _ = model.decode_step(
        params, caches, torch.from_numpy(batch["tokens"][:, -1]),
        torch.full((B,), pos_last, dtype=torch.int32))
    np.testing.assert_allclose(logits2.numpy(), full_logits.numpy(),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    # the prefill's logits are the JAX package's
    want, _ = jmodel32.prefill(jparams, to_jax(batch), max_len=S + 8)
    np.testing.assert_allclose(full_logits.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL, err_msg=aid)


def test_param_counts_sane(arch_setup):
    aid, cfg, model, params, jmodel32, _ = arch_setup
    counts = model.param_counts()
    n_leaves = sum(t.numel() for t in leaves(params))
    assert counts["total"] == pytest.approx(float(n_leaves))
    if cfg.is_moe:
        assert counts["active"] < counts["total"] - counts["embed"] + 1
    assert counts == jbuild_model(jget_config(aid).smoke()).param_counts()
    assert build_model(get_config(aid)).param_counts() == \
        jbuild_model(jget_config(aid)).param_counts(), aid
