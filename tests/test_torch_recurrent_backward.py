"""The backward of the port's recurrent kernels on the CPU: the autograd
``Function`` of ``mlstm_chunkwise`` and of ``rg_lru_scan``, whose
backward on a CPU tensor is the plain version of the backward kernel
(``mlstm_backward_plain``, ``rg_lru_backward_plain``), held against
autograd through the plain forwards, against ``jax.vjp`` of the JAX
package's layers and scan, and through the ``Trainer``; and the sLSTM
layer's time loop in training (``recurrent._SLSTMScan``, whose backward
is a reverse loop over the saved states), against autograd of its steps
in float64 and ``jax.vjp`` of the JAX package's layer.

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

At a tie |den| = 1 the plain backward takes JAX's rule, the gradient
of the reference's ``jnp.maximum(jnp.abs(den), 1.0)``: half of it
reaches den, where autograd of ``mlstm_plain``'s ``clamp_min`` passes
all of it.  So the comparisons with autograd keep every |den| off 1,
and one case builds an exact tie and holds the port to ``jax.vjp`` of
the JAX package's layer there.
"""

import dataclasses
import math

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


def _tie_inputs(B, S, H, m, seed):
    """q, k, v, i_gate, log_f with an exact tie at (batch 0, token 0,
    head 0): q_0 = (sqrt(m), 0, ...), k_0 = (1, 0, ...), i_0 = 1, so
    den_0 = (q_0 / sqrt(m)) . k_0 i_0 = 1 in float32 (m a power of 4:
    sqrt(m) and its division exact), the entering state being zero."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, m)).astype(np.float32)
               for _ in range(3))
    i = rng.uniform(0.05, 0.95, (B, S, H)).astype(np.float32)
    lf = -rng.uniform(0.0, 1.0, (B, S, H)).astype(np.float32)
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0] = math.sqrt(m)
    k[0, 0, 0] = 0.0
    k[0, 0, 0, 0] = 1.0
    i[0, 0, 0] = 1.0
    return q, k, v, i, lf


def test_mlstm_gradients_at_den_one_match_jax_vjp(monkeypatch):
    """At an exact tie |den| = 1 the port's mLSTM gradients (through
    ``mlstm_chunkwise`` on the CPU, the plain backward) are JAX's, which
    halve what reaches den there.  The reference is ``jax.vjp`` of the
    JAX package's ``MLSTMLayer.apply(mode="train")`` -- its Pallas
    ``mlstm_chunkwise`` has no JAX gradient (``jax.vjp`` of its
    ``pallas_call`` fails in interpret mode) -- brought to the tie by
    patching the layer's ``_qkv_gates`` to hand back these q, k, v, i,
    log_f (the port's layer likewise), with the JAX layer's parameters
    (smoke() width, 8 heads so that m = 16; rec_chunk 8, two chunks).
    Each gradient w.r.t. q, k, v, i, log_f within ``REF_TOL`` of its
    largest; torch's ``clamp_min`` rule misses by more."""
    cfg = dataclasses.replace(get_config("xlstm_350m").smoke(),
                              dtype="float32", n_heads=8)
    jcfg = dataclasses.replace(jget_config("xlstm_350m").smoke(),
                               dtype="float32", n_heads=8)
    _, H, m = TR.MLSTMLayer._dims(cfg)
    assert m == 16 and JR.MLSTMLayer._dims(jcfg)[1:] == (H, m)
    B, S = 2, 16
    ins = _tie_inputs(B, S, H, m, seed=31)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jp = JR.MLSTMLayer.init(jcfg, jax.random.key(33))

    def jlayer(q, k, v, i, lf):
        # the JAX layer's own _qkv_gates returns q already scaled
        monkeypatch.setattr(JR.MLSTMLayer, "_qkv_gates", staticmethod(
            lambda *_: (q / math.sqrt(m), k, v, i, lf, None)))
        return JR.MLSTMLayer.apply(jcfg, jp, jnp.asarray(x),
                                   mode="train")[0]

    _, vjp = jax.vjp(jlayer, *map(jnp.asarray, ins))
    want = [np.asarray(g) for g in vjp(jnp.asarray(gy))]

    def port_grads():
        leaves_ = [torch.from_numpy(a.copy()).requires_grad_(True)
                   for a in ins]
        monkeypatch.setattr(TR.MLSTMLayer, "_qkv_gates", staticmethod(
            lambda *_: (*leaves_, None)))
        y, _ = TR.MLSTMLayer.apply(cfg, to_torch(jp), torch.from_numpy(x),
                                   mode="train")
        return torch.autograd.grad(y, leaves_, torch.from_numpy(gy))

    _, _, _, den = ML.mlstm_plain(*map(torch.from_numpy, ins), chunk=8,
                                  save=True)
    assert float(den[0, 0, 0]) == 1.0  # the tie, exactly
    assert_grads_close(port_grads(), want, REF_TOL, "mlstm at |den| = 1")
    # torch's rule at the tie (autograd through mlstm_plain's clamp_min)
    # is not JAX's: the case pins the tie
    monkeypatch.setattr(mlstm_ops, "mlstm_chunkwise",
                        lambda *a, chunk, return_state: ML.mlstm_plain(
                            *a, chunk=chunk, return_state=return_state))
    with pytest.raises(AssertionError):
        assert_grads_close(port_grads(), want, REF_TOL, "clamp_min rule")


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
    ("recurrentgemma_2b", "RGLRULayer", 130),
    ("xlstm_350m", "SLSTMLayer", 24), ("xlstm_350m", "SLSTMLayer", 40)])
def test_layer_train_gradients_match_jax_vjp(arch, layer, S):
    """The layer's train-mode gradients, w.r.t. its input and every
    parameter, against ``jax.vjp`` of the JAX package's layer at
    ``smoke()`` size in float32 (rec_chunk 8: three and five mLSTM
    chunks; the RG-LRU in one and three of its 64-step chunks; the
    sLSTM's reverse loop, ``_SLSTMScan``, against the gradient of the
    reference's ``lax.scan``)."""
    _layer_vjp_check(arch, layer, S, 2)


def slstm_inputs(H, B, hd, S, seed, low_n_steps=0):
    """float64 (r, bias, pre) and initial states (c, n, h) of
    ``SLSTMLayer.scan``.  The first ``low_n_steps`` steps take the input
    gate's preactivation at -30 on half of the units: their n stays below
    the clamp's 1e-6 there, from an initial n of 0."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape))

    r, bias = t(H, hd, 4 * hd, scale=0.5), t(H, 1, 4 * hd, scale=0.5)
    pre = t(S, H, B, 4 * hd)
    c, h = t(H, B, hd), t(H, B, hd)
    n = torch.from_numpy(rng.uniform(0.5, 2.0, (H, B, hd)))
    if low_n_steps:
        pre.view(S, H, B, 4, hd)[:low_n_steps, :, :, 1, : hd // 2] = -30.0
        # c small enough that h = o c / 1e-6 stays of order 0.1, large
        # enough that the clamped branch's dn would move the gradients
        c[:, :, : hd // 2] *= 1e-7
        n[:, :, : hd // 2] = 0.0
    return (r, bias, pre), (c, n, h)


def autograd_slstm(leaves_, states):
    """The sLSTM's hs through ``SLSTMLayer._step`` step by step, for
    autograd to differentiate."""
    r, bias, pre = leaves_
    state, hs = states, []
    for t in range(pre.shape[0]):
        state = TR.SLSTMLayer._step(r, bias, pre[t], *state)
        hs.append(state[2])
    return torch.stack(hs)


@pytest.mark.parametrize("low_n_steps", [0, 3])
def test_slstm_scan_backward_matches_autograd_float64(low_n_steps):
    """``_SLSTMScan``'s reverse loop against autograd of the same steps
    through ``SLSTMLayer._step`` in float64, every input gradient within
    ``F64_TOL`` of its largest; with ``low_n_steps`` the first steps run
    the clamp's branch (n < 1e-6: no gradient reaches n through it)."""
    H, B, hd, S = 2, 3, 8, 12
    ins, states = slstm_inputs(H, B, hd, S, seed=31 + low_n_steps,
                               low_n_steps=low_n_steps)
    if low_n_steps:
        with torch.no_grad():
            (_, ns, _), _ = TR.SLSTMLayer.scan(*ins, *states, keep=True)
        assert bool((ns[1:low_n_steps + 1, :, :, : hd // 2] < 1e-6).all())
        assert bool((ns[1:, :, :, hd // 2:] >= 1e-6).all())
    dhs = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (S, H, B, hd)))
    leaves_ = [t.clone().requires_grad_(True) for t in ins]
    hs = TR._SLSTMScan.apply(*leaves_, *states)
    want_hs = autograd_slstm(leaves_, states)
    assert torch.equal(hs, want_hs)
    got = torch.autograd.grad(hs, leaves_, dhs)
    want = torch.autograd.grad(want_hs, leaves_, dhs)
    assert all(g.dtype == torch.float64 for g in got)
    assert_grads_close(got, want, F64_TOL, f"slstm low n {low_n_steps}")


def test_mlstm_layer_gradients_at_chunk_256_match_jax_vjp():
    """The port's layer at the full configs' rec_chunk of 256 (two chunks
    of 256: the backward kernel's grads pass takes them in row blocks of
    128 on the card; here the plain backward) against ``jax.vjp`` of the
    JAX package's layer.  The JAX layer's own gradient at chunk 256 is
    not finite: its ``where(mask, exp(cum_t - cum_s), 0)`` overflows above
    the diagonal and the ``where``'s gradient multiplies that inf by 0.
    So the JAX side runs rec_chunk 8, whose gradient is the same function
    up to rounding (chunks change only the order of sums)."""
    _layer_vjp_check("xlstm_350m", "MLSTMLayer", 512, 1,
                     port={"rec_chunk": 256}, ref={"rec_chunk": 8})


def test_mlstm_backward_at_chunk_256_matches_autograd_of_plain():
    B, S, H, m, c = 1, 512, 2, 24, 256
    ins = mlstm_inputs(B, S, H, m, seed=77)
    dh = torch.from_numpy(np.random.default_rng(78).standard_normal(
        (B, S, H, m)).astype(np.float32))
    leaves_ = [t.clone().requires_grad_(True) for t in ins]
    h = mlstm_ops.mlstm_chunkwise(*leaves_, chunk=c)
    got = torch.autograd.grad(h, leaves_, dh)
    assert_grads_close(got, autograd_mlstm(ins, (dh,), c, False), F32_TOL,
                       "mlstm chunk 256")


def _layer_vjp_check(arch, layer, S, batch, port=None, ref=None):
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32",
                              **(port or {}))
    jcfg = dataclasses.replace(jget_config(arch).smoke(), dtype="float32",
                               **(ref or {}))
    jl, tl = getattr(JR, layer), getattr(TR, layer)
    jp = jl.init(jcfg, jax.random.key(21))
    rng = np.random.default_rng(22)
    x = rng.standard_normal((batch, S, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((batch, S, cfg.d_model)).astype(np.float32)
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
