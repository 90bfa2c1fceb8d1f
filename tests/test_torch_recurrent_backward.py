"""The backward of the port's recurrent kernels on the CPU: the autograd
``Function`` of ``mlstm_chunkwise`` and of ``rg_lru_scan``, whose
backward on a CPU tensor is the plain version of the backward kernel
(``mlstm_backward_plain``, ``rg_lru_backward_plain``), held against
autograd through the plain forwards, against ``jax.vjp`` of the JAX
package's layers and scan, and through the ``Trainer``.

Tolerances:

* ``F32_TOL`` = 1e-5 of the largest gradient, a backward against autograd
  of the same plain forward in float32: the same math, summed in another
  order (a chunk's terms are gathered by hand, autograd follows the
  forward's graph); ``F64_TOL`` = 1e-12 of it in float64.
* ``REF_TOL`` = 1e-4 of each leaf's largest gradient, the port's layers
  against ``jax.vjp`` of the JAX package's in float32: other algorithms
  (a chunked scan against an associative scan, another matmul order),
  as ``tests/test_torch_recurrent_models.py``'s 1e-4 for their outputs.
* ``STEP_TOL`` = 1e-4, three ``Trainer`` steps against the JAX
  ``Trainer``: losses relative, parameters within 1e-4 of their value
  plus 1e-4 of the leaf's largest, as ``tests/test_torch_models_smoke.py``
  holds one step.

Inputs stay off |den| = 1, where torch's ``clamp_min`` passes the
gradient and JAX's ``maximum`` halves it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.rg_lru.ref import rg_lru_scan as jrg_lru_scan
from repro.models import recurrent as JR
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.mlstm import mlstm as ML
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.kernels.rg_lru import rg_lru as RL
from repro_torch.models import build_model
from repro_torch.models import recurrent as TR
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.tree import leaves, leaves_with_paths, map_tree

torch.set_num_threads(1)

CPU = "cpu"
F32_TOL = 1e-5
F64_TOL = 1e-12
REF_TOL = 1e-4
STEP_TOL = 1e-4
ARCHS = ("xlstm_350m", "recurrentgemma_2b")


def assert_grads_close(got, want, tol, what):
    """Each gradient within ``tol`` of the largest of its reference."""
    assert len(got) == len(want), what
    for n, (g, w) in enumerate(zip(got, want)):
        g, w = (x if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.array(x)) for x in (g, w))
        assert g.shape == w.shape, (what, n, g.shape, w.shape)
        top = float(w.abs().max()) if w.numel() else 0.0
        err = float((g.double() - w.double()).abs().max()) if w.numel() \
            else 0.0
        assert err <= tol * top, f"{what} [{n}]: {err} > {tol} * {top}"


def mlstm_inputs(B, S, H, m, seed, *, dtype=np.float32, q_scale=1.0,
                 lf_scale=1.0):
    """q, k, v (B,S,H,m), i_gate in (0, 1), log_f in (-lf_scale, 0]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, m)) * q_scale
    k, v = (rng.standard_normal((B, S, H, m)) for _ in range(2))
    i = rng.uniform(0.0, 1.0, (B, S, H))
    lf = -rng.uniform(0.0, lf_scale, (B, S, H))
    return [torch.from_numpy(x.astype(dtype)) for x in (q, k, v, i, lf)]


def autograd_mlstm(ins, seeds, chunk, return_state, which=range(5)):
    leaves_ = [t.clone().requires_grad_(n in which)
               for n, t in enumerate(ins)]
    out = ML.mlstm_plain(*leaves_, chunk=chunk, return_state=return_state)
    outs = out if return_state else (out,)
    return torch.autograd.grad(outs, [leaves_[n] for n in which], seeds)


# ------------------------------------------------------------- mLSTM ----
MLSTM_CASES = [
    # (B, S, H, m, chunk, q_scale, lf_scale): widths that are not
    # multiples of 16, one chunk, |den| on both sides of 1, log_f near 0
    # and strongly negative
    (2, 48, 3, 40, 16, 1.0, 1.0),
    (1, 16, 2, 24, 16, 1.0, 1.0),
    (2, 64, 2, 32, 16, 4.0, 1.0),
    (1, 64, 2, 32, 16, 1.0, 0.01),
    (1, 64, 2, 32, 16, 1.0, 4.0),
]


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_function_backward_matches_autograd_of_plain(case):
    """``mlstm_chunkwise``'s gradients (the plain backward) against
    ``torch.autograd.grad`` through ``mlstm_plain``, float32."""
    B, S, H, m, c, qs, lfs = case
    ins = mlstm_inputs(B, S, H, m, seed=S + m, q_scale=qs, lf_scale=lfs)
    dh = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, H, m)).astype(np.float32))
    leaves_ = [t.clone().requires_grad_(True) for t in ins]
    before = ML.backward_launches
    h = mlstm_ops.mlstm_chunkwise(*leaves_, chunk=c)
    assert h.grad_fn is not None
    got = torch.autograd.grad(h, leaves_, dh)
    assert ML.backward_launches == before  # the CPU launches nothing
    assert_grads_close(got, autograd_mlstm(ins, (dh,), c, False), F32_TOL,
                       f"mlstm {case}")


def test_mlstm_cases_straddle_den_one():
    """The cases above reach both branches of the clamp."""
    shares = []
    for B, S, H, m, c, qs, lfs in MLSTM_CASES:
        ins = mlstm_inputs(B, S, H, m, seed=S + m, q_scale=qs, lf_scale=lfs)
        _, _, _, den = ML.mlstm_plain(*ins, chunk=c, save=True)
        shares.append(float((den.abs() > 1).float().mean()))
        assert float((den.abs() - 1).abs().min()) > 1e-6
    assert min(shares) < 0.5 < max(shares), shares


def test_mlstm_backward_plain_float64():
    """In float64 the plain backward is autograd's to rounding."""
    ins = mlstm_inputs(2, 48, 2, 24, seed=3, dtype=np.float64)
    rng = np.random.default_rng(4)
    dh = torch.from_numpy(rng.standard_normal((2, 48, 2, 24)))
    dc = torch.from_numpy(rng.standard_normal((2, 2, 24, 24)))
    dn = torch.from_numpy(rng.standard_normal((2, 2, 24)))
    h, cin, nin, den = ML.mlstm_plain(*ins, chunk=16, save=True)
    got = ML.mlstm_backward_plain(*ins, h, cin, nin, den, dh, dc, dn,
                                  chunk=16)
    assert all(g.dtype == torch.float64 for g in got)
    assert_grads_close(got, autograd_mlstm(ins, (dh, dc, dn), 16, True),
                       F64_TOL, "mlstm float64")


def test_mlstm_return_state_seeds():
    """The gradients of the returned final (C, n) seed the walk."""
    ins = mlstm_inputs(1, 64, 2, 32, seed=5)
    rng = np.random.default_rng(6)
    seeds = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((1, 64, 2, 32), (1, 2, 32, 32), (1, 2, 32)))
    leaves_ = [t.clone().requires_grad_(True) for t in ins]
    h, C, n = mlstm_ops.mlstm_chunkwise(*leaves_, chunk=16,
                                        return_state=True)
    got = torch.autograd.grad((h, C, n), leaves_, seeds)
    assert_grads_close(got, autograd_mlstm(ins, seeds, 16, True), F32_TOL,
                       "mlstm seeds")
    # the state alone (h unused) reaches every input too
    h, C, n = mlstm_ops.mlstm_chunkwise(*leaves_, chunk=16,
                                        return_state=True)
    got = torch.autograd.grad((C, n), leaves_, seeds[1:])
    want = autograd_mlstm(ins, (torch.zeros_like(seeds[0]),) + seeds[1:],
                          16, True)
    assert_grads_close(got, want, F32_TOL, "mlstm state only")


@pytest.mark.parametrize("which", [(0,), (1, 2), (3, 4), (0, 4)])
def test_mlstm_needs_input_grad_subsets(which):
    """Only some inputs require grad: those get autograd's gradients."""
    ins = mlstm_inputs(1, 32, 2, 16, seed=7)
    dh = torch.ones((1, 32, 2, 16))
    leaves_ = [t.clone().requires_grad_(n in which)
               for n, t in enumerate(ins)]
    h = mlstm_ops.mlstm_chunkwise(*leaves_, chunk=8)
    got = torch.autograd.grad(h, [leaves_[n] for n in which], dh)
    assert_grads_close(got, autograd_mlstm(ins, (dh,), 8, False, which),
                       F32_TOL, f"mlstm subset {which}")


def test_mlstm_saves_nothing_without_grad():
    """No input requiring grad (or grad off): no graph, same h."""
    ins = mlstm_inputs(1, 32, 2, 16, seed=8)
    h = mlstm_ops.mlstm_chunkwise(*ins, chunk=8)
    assert h.grad_fn is None
    with torch.no_grad():
        h2 = mlstm_ops.mlstm_chunkwise(
            *[t.clone().requires_grad_(True) for t in ins], chunk=8)
    assert h2.grad_fn is None and torch.equal(h, h2)
    assert torch.equal(h, ML.mlstm_plain(*ins, chunk=8))


# ------------------------------------------------------------ RG-LRU ----
RG_CASES = [(2, 64, 200), (2, 65, 200), (1, 200, 128), (1, 1, 8), (2, 0, 8)]


def rg_inputs(B, S, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (B, S, D))
    b = rng.standard_normal((B, S, D))
    h0 = rng.standard_normal((B, D))
    dhs = rng.standard_normal((B, S, D))
    dhn = rng.standard_normal((B, D))
    return [torch.from_numpy(x.astype(dtype)) for x in (a, b, h0, dhs, dhn)]


def autograd_rg(a, b, h0, dhs, dhn):
    a, b, h0 = (t.clone().requires_grad_(True) for t in (a, b, h0))
    hs, hn = RL.rg_lru_plain(a, b, h0)
    return torch.autograd.grad((hs, hn), (a, b, h0), (dhs, dhn),
                               allow_unused=True)


@pytest.mark.parametrize("shape", RG_CASES)
def test_rg_lru_function_backward_matches_autograd_of_plain(shape):
    """``rg_lru_scan``'s gradients (the plain backward) against autograd
    through ``rg_lru_plain`` with nonzero h0 and dh_final, float32; in
    float64 the plain backward against autograd of the float64 scan."""
    a, b, h0, dhs, dhn = rg_inputs(*shape, seed=sum(shape))
    leaves_ = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    before = RL.backward_launches
    hs, hn = rg_ops.rg_lru_scan(*leaves_)
    assert hs.grad_fn is not None
    got = torch.autograd.grad((hs, hn), leaves_, (dhs, dhn))
    assert RL.backward_launches == before
    want = [torch.zeros_like(t) if g is None else g
            for t, g in zip((a, b, h0), autograd_rg(a, b, h0, dhs, dhn))]
    assert_grads_close(got, want, F32_TOL, f"rg_lru {shape}")
    a, b, h0, dhs, dhn = rg_inputs(*shape, seed=sum(shape), dtype=np.float64)
    hs, _ = RL.rg_lru_plain(a, b, h0)
    got = RL.rg_lru_backward_plain(a, hs, h0, dhs, dhn)
    want = [torch.zeros_like(t) if g is None else g
            for t, g in zip((a, b, h0), autograd_rg(a, b, h0, dhs, dhn))]
    assert_grads_close(got, want, F64_TOL, f"rg_lru float64 {shape}")


@pytest.mark.parametrize("shape", [(2, 64, 200), (2, 130, 40), (1, 7, 16)])
def test_rg_lru_backward_matches_jax_vjp(shape):
    """Against ``jax.vjp`` of the JAX package's ``associative_scan``
    oracle, nonzero h0, dh_seq and dh_final."""
    a, b, h0, dhs, dhn = rg_inputs(*shape, seed=11)
    leaves_ = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    got = torch.autograd.grad(rg_ops.rg_lru_scan(*leaves_), leaves_,
                              (dhs, dhn))
    _, vjp = jax.vjp(jrg_lru_scan, *(jnp.asarray(t.numpy())
                                      for t in (a, b, h0)))
    want = vjp((jnp.asarray(dhs.numpy()), jnp.asarray(dhn.numpy())))
    assert_grads_close(got, [np.asarray(w) for w in want], REF_TOL,
                       f"rg_lru vs jax {shape}")


@pytest.mark.parametrize("which", [(0,), (1,), (2,), (0, 2)])
def test_rg_lru_needs_input_grad_subsets(which):
    a, b, h0, dhs, dhn = rg_inputs(1, 70, 16, seed=12)
    leaves_ = [t.clone().requires_grad_(n in which)
               for n, t in enumerate((a, b, h0))]
    hs, hn = rg_ops.rg_lru_scan(*leaves_)
    got = torch.autograd.grad((hs, hn), [leaves_[n] for n in which],
                              (dhs, dhn))
    want = autograd_rg(a, b, h0, dhs, dhn)
    assert_grads_close(got, [want[n] for n in which], F32_TOL,
                       f"rg_lru subset {which}")


def test_rg_lru_final_state_alone():
    """Only h_final used: the seed enters at the last step."""
    a, b, h0, _, dhn = rg_inputs(1, 70, 16, seed=13)
    leaves_ = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    _, hn = rg_ops.rg_lru_scan(*leaves_)
    got = torch.autograd.grad(hn, leaves_, dhn)
    want = autograd_rg(a, b, h0, torch.zeros_like(a), dhn)
    assert_grads_close(got, want, F32_TOL, "rg_lru h_final only")


# ------------------------------------------- layers against jax.vjp ----
def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.asarray(v, np.float32).copy())
            for k, v in tree.items()}


def flat(tree, path=()):
    """(path, leaf) in sorted key order (JAX's pytree order for dicts)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += flat(v, path + (k,)) if isinstance(v, dict) else [
            (path + (k,), v)]
    return out


@pytest.mark.parametrize("arch,layer,S", [
    ("xlstm_350m", "MLSTMLayer", 24), ("xlstm_350m", "MLSTMLayer", 40),
    ("recurrentgemma_2b", "RGLRULayer", 24),
    ("recurrentgemma_2b", "RGLRULayer", 130)])
def test_layer_train_gradients_match_jax_vjp(arch, layer, S):
    """The layer's train-mode gradients, w.r.t. its input and every
    parameter, against ``jax.vjp`` of the JAX package's layer at
    ``smoke()`` size in float32 (rec_chunk 8: three and five mLSTM
    chunks; the RG-LRU in one and three of its 64-step chunks)."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    jcfg = dataclasses.replace(jget_config(arch).smoke(), dtype="float32")
    jl, tl = getattr(JR, layer), getattr(TR, layer)
    jp = jl.init(jcfg, jax.random.key(21))
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jy, vjp = jax.vjp(lambda p, x: jl.apply(jcfg, p, x, mode="train")[0],
                      jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(gy))
    tp = to_torch(jp)
    for _, t in flat(tp):
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, cache = tl.apply(cfg, tp, xt, mode="train")
    assert cache is None
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=REF_TOL, atol=REF_TOL)
    named = flat(tp)
    grads = torch.autograd.grad(ty, [xt] + [t for _, t in named],
                                torch.from_numpy(gy), allow_unused=True)
    want = [np.asarray(jgx)] + [np.asarray(w) for _, w in flat(jgp)]
    assert [p for p, _ in flat(jgp)] == [p for p, _ in named]
    for (path, t), g, w in zip([(("x",), xt)] + named, grads, want):
        g = torch.zeros_like(t) if g is None else g
        assert_grads_close([g], [w], REF_TOL, f"{layer} d{'/'.join(path)}")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_gradients(arch):
    """Per-layer remat recomputes each layer's forward, kernels and all,
    in the backward: the gradients are the same bits as without it."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(
        cfg, 2, 32, seed=0).batch_at(0).items()}
    grads = []
    for remat in (True, False):
        tree = map_tree(lambda t: t.clone().requires_grad_(True), params)
        loss = model.loss(tree, batch, remat=remat)
        grads.append(torch.autograd.grad(loss, leaves(tree),
                                         allow_unused=True))
    for (path, _), a, b in zip(leaves_with_paths(params), *grads):
        assert (a is None) == (b is None), path
        if a is not None:
            assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_three_steps_match_jax_trainer(arch, tmp_path):
    """Three ``Trainer`` steps (remat on, AdamW) from the JAX Trainer's
    initial weights, float32: every step's loss and the final parameters
    against the JAX package's ``Trainer``."""
    jcfg = dataclasses.replace(jget_config(arch).smoke(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    jt = JTrainer(jcfg, 2, 32, tcfg=JTrainerConfig(
        steps=3, ckpt_every=100, ckpt_dir=str(tmp_path / "jax"),
        log_every=1))
    jt.init_state()
    t = Trainer(cfg, 2, 32, tcfg=TrainerConfig(
        steps=3, ckpt_every=100, ckpt_dir=str(tmp_path / "port"),
        log_every=1), device=CPU)
    t.params = params_from_jax(cfg, jax.tree.map(np.asarray, jt.params),
                               device=CPU, dtype=torch.float32)
    t.opt_state = adamw_init(t.params)
    rep, jrep = t.run(), jt.run()
    assert rep["final_step"] == jrep["final_step"] == 3
    for got, want in zip(rep["metrics"], jrep["metrics"], strict=True):
        assert got["step"] == want["step"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=STEP_TOL,
                                   err_msg=f"{arch} step {got['step']}")
    ref = params_from_jax(cfg, jax.tree.map(np.asarray, jt.params),
                          device=CPU, dtype=torch.float32)
    for (path, a), b in zip(leaves_with_paths(t.params), leaves(ref)):
        np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=STEP_TOL,
            atol=STEP_TOL * float(b.abs().max()),
            err_msg=f"{arch} {'/'.join(map(str, path))}")
