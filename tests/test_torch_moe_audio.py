"""The port's MoE and audio blocks against the JAX package, on the CPU, in
float32: ``moe_apply``, ``MoELayer``, ``EncoderLayer`` and ``CrossLayer``
in train, prefill and decode mode, every cache leaf included (the cross
layer's ``xk``/``xv``), within ``TOL`` = 1e-5.

Weights are the JAX blocks' own ``init`` carried across as tensors;
inputs come from numpy seeds.  Routing is held exactly: a capacity
factor that forces drops gives the reference's keep mask, and a zero
router (every probability tied) picks experts 0..K−1, as
``jax.lax.top_k`` breaks ties.  The reference's keep mask is computed by
its own routing lines (``src/repro/models/blocks.py`` ``moe_apply``:
top-k, stable argsort, exclusive offsets, ``pos < capacity``) in
``jax_routing`` below, since its ``moe_apply`` returns the output alone.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import blocks as JB
from repro_torch.configs import get_config
from repro_torch.models import blocks as TB

torch.set_num_threads(1)

TOL = 1e-5
B, S = 2, 16


def cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(get_config(arch).smoke(), **kw),
            dataclasses.replace(jget_config(arch).smoke(), **kw))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32).copy())


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol,
                               err_msg=what)


def close_tree(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), (what, k)
        close(got[k], want[k], f"{what}: {k}")


def x_input(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)


def jax_routing(cfg, params, x):
    """The reference's routing for one dispatch group (no mesh): expert
    ids and the keep mask, (tokens, K) in top-k order."""
    T = x.shape[0] * x.shape[1]
    K, E = cfg.top_k, cfg.n_experts
    capacity = max(1, int(math.ceil(T * K / E * cfg.capacity_factor)))
    logits = (x.reshape(T, -1) @ params["router"]).astype(jnp.float32)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    te = eidx.reshape(T * K)
    order = jnp.argsort(te)
    se = te[order]
    counts = jnp.zeros((E,), jnp.int32).at[se].add(1)
    offsets = jnp.cumsum(counts) - counts
    pos = jnp.arange(T * K) - offsets[se]
    keep = jnp.zeros((T * K,), bool).at[order].set(pos < capacity)
    return np.asarray(eidx), np.asarray(keep).reshape(T, K), capacity


# ------------------------------------------------------------------ MoE ----
@pytest.mark.parametrize("arch,capacity_factor", [
    ("granite_moe_3b_a800m", None),   # the smoke config: drop-free
    ("granite_moe_3b_a800m", 0.5),    # forces drops
    ("qwen3_moe_235b_a22b", 0.75),
])
def test_moe_apply_matches_reference(arch, capacity_factor):
    kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    cfg, jcfg = cfgs(arch, **kw)
    jp = JB.moe_init(jcfg, jax.random.key(3))
    x = x_input(cfg, 0)
    want = JB.moe_apply(jcfg, jp, jnp.asarray(x))
    got, routing = TB.moe_apply(cfg, to_torch(jp), torch.from_numpy(x),
                                return_routing=True)
    close(got, want, f"{arch} moe_apply")
    eidx, keep, capacity = jax_routing(jcfg, jp, jnp.asarray(x))
    assert routing["capacity"] == capacity == TB.moe_capacity(cfg, B * S)
    np.testing.assert_array_equal(routing["experts"].numpy(), eidx)
    np.testing.assert_array_equal(routing["keep"].numpy(), keep)
    if capacity_factor is None:
        assert keep.all()
    else:
        assert not keep.all(), "the capacity factor must force drops"


def test_moe_zero_router_ties_go_to_lower_experts():
    """Every router probability tied: experts 0..K−1 for every token, as
    ``jax.lax.top_k`` picks them, and the reference's output."""
    cfg, jcfg = cfgs("granite_moe_3b_a800m", capacity_factor=8.0)
    jp = JB.moe_init(jcfg, jax.random.key(4))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x = x_input(cfg, 1)
    got, routing = TB.moe_apply(cfg, to_torch(jp), torch.from_numpy(x),
                                return_routing=True)
    want_ids = np.broadcast_to(np.arange(cfg.top_k), (B * S, cfg.top_k))
    np.testing.assert_array_equal(routing["experts"].numpy(), want_ids)
    np.testing.assert_array_equal(jax_routing(jcfg, jp, jnp.asarray(x))[0],
                                  want_ids)
    close(got, JB.moe_apply(jcfg, jp, jnp.asarray(x)), "zero router")


def test_moe_apply_gradients_match_reference():
    """The gradients of a scalar of ``moe_apply`` with respect to x and
    every weight, drops included (the dispatch and combine are gathers)."""
    cfg, jcfg = cfgs("granite_moe_3b_a800m", capacity_factor=0.5)
    jp = JB.moe_init(jcfg, jax.random.key(5))
    x = x_input(cfg, 2)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(JB.moe_apply(jcfg, p, xx) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in to_torch(jp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (TB.moe_apply(cfg, tp, tx) * torch.from_numpy(w)).sum().backward()
    close(tx.grad, jgx, "d/dx", 1e-4)
    for k in tp:
        close(tp[k].grad, jgp[k], f"d/d{k}", 1e-4)


def layer_case(block, arch, seed=0, **kw):
    cfg, jcfg = cfgs(arch, **kw)
    jp = getattr(JB, block).init(jcfg, jax.random.key(seed))
    return cfg, jcfg, jp, to_torch(jp)


def run_modes(block, cfg, jcfg, jp, tp, x, extras=None, jextras=None):
    """train, prefill (its cache) and two decode steps from the prefill's
    cache, both packages; compared as they go."""
    TBk, JBk = getattr(TB, block), getattr(JB, block)
    extras, jextras = dict(extras or {}), dict(jextras or {})
    got, gc = TBk.apply(cfg, tp, torch.from_numpy(x), mode="train",
                        extras=extras)
    want, _ = JBk.apply(jcfg, jp, jnp.asarray(x), mode="train",
                        extras=jextras)
    assert gc is None
    close(got, want, f"{block} train")
    ml = x.shape[1] + 4
    got, gc = TBk.apply(cfg, tp, torch.from_numpy(x[:, :-2]), mode="prefill",
                        extras=dict(extras, max_len=ml))
    want, wc = JBk.apply(jcfg, jp, jnp.asarray(x[:, :-2]), mode="prefill",
                         extras=dict(jextras, max_len=ml))
    close(got, want, f"{block} prefill")
    close_tree(gc, wc, f"{block} prefill cache")
    for i in (2, 1):
        p = x.shape[1] - i
        pos = np.full((B,), p, np.int32)
        got, gc = TBk.apply(cfg, tp, torch.from_numpy(x[:, p:p + 1]),
                            mode="decode", cache=gc,
                            pos=torch.from_numpy(pos))
        want, wc = JBk.apply(jcfg, jp, jnp.asarray(x[:, p:p + 1]),
                             mode="decode", cache=wc, pos=jnp.asarray(pos))
        close(got, want, f"{block} decode at {p}")
        close_tree(gc, wc, f"{block} decode cache at {p}")


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_layer_matches_reference(capacity_factor):
    kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    cfg, jcfg, jp, tp = layer_case("MoELayer", "granite_moe_3b_a800m", **kw)
    run_modes("MoELayer", cfg, jcfg, jp, tp, x_input(cfg, 3))


# ---------------------------------------------------------------- audio ----
def test_encoder_layer_matches_reference():
    cfg, jcfg, jp, tp = layer_case("EncoderLayer", "whisper_large_v3")
    x = x_input(cfg, 4, s=cfg.enc_seq)
    for mode in ("train", "prefill"):
        got, _ = TB.EncoderLayer.apply(cfg, tp, torch.from_numpy(x),
                                       mode=mode)
        want, _ = JB.EncoderLayer.apply(jcfg, jp, jnp.asarray(x), mode=mode)
        close(got, want, f"EncoderLayer {mode}")
    assert TB.EncoderLayer.init_cache(cfg, B, 8) == {}


def test_cross_layer_matches_reference():
    """Self-attention cache and the encoder's keys and values (``xk``,
    ``xv``) built by prefill, read by decode."""
    cfg, jcfg, jp, tp = layer_case("CrossLayer", "whisper_large_v3")
    enc = x_input(cfg, 5, s=cfg.enc_seq)
    run_modes("CrossLayer", cfg, jcfg, jp, tp, x_input(cfg, 6),
              extras={"enc": torch.from_numpy(enc)},
              jextras={"enc": jnp.asarray(enc)})


def test_cross_layer_cache_init_matches_reference():
    cfg, jcfg = cfgs("whisper_large_v3")
    got = TB.CrossLayer.init_cache(cfg, B, 24, device="cpu")
    want = JB.CrossLayer.init_cache(jcfg, B, 24)
    close_tree(got, want, "CrossLayer.init_cache")
    assert got["xk"].dtype == torch.float32


def test_dense_layer_train_mode_matches_reference():
    """Train mode is prefill without the cache."""
    cfg, jcfg, jp, tp = layer_case("DenseLayer", "llama3_8b")
    run_modes("DenseLayer", cfg, jcfg, jp, tp, x_input(cfg, 7))


def test_unknown_mode_raises():
    cfg, _, _, tp = layer_case("MoELayer", "granite_moe_3b_a800m")
    with pytest.raises(ValueError, match="mode"):
        TB.MoELayer.apply(cfg, tp, torch.zeros((B, 4, cfg.d_model)),
                          mode="probe")
