"""Model primitives on torch: norms, RoPE, GQA attention (row-chunked),
MLPs, embeddings and the chunked cross-entropy loss.

Conventions (the JAX package's, ``src/repro/models/layers.py``)
-----------------------------------------------------------------
* Params are plain dicts of tensors.  They are made in ``param_dtype``
  (float32) and held in the compute dtype (``cfg.dtype``): the reference
  casts each weight to the compute dtype at every use, which gives the
  same bits as casting once when the weights are made or loaded.
* Softmax and norm statistics are computed in float32; products that the
  reference asks for with ``preferred_element_type=float32`` take float32
  operands here (a bf16 → f32 widening is exact).
* Full-sequence attention is row-chunked over queries (``q_chunk``).
* GQA: KV heads are repeated by the smallest factor making them
  shardable over the tensor-model axis (:func:`kv_repeat_factor`); when
  no factor works (e.g. 40-head MHA on a 16-wide axis) K/V switch to a
  sequence-sharded layout over the model axis.  ``shard(...)`` marks
  where the reference constrains a layout.  Without a mesh (one device)
  the factor is 1 and every ``shard`` returns its input.
* On a mesh (DTensors), attention runs on each rank's shards, as GSPMD
  partitions the reference's einsums: on its heads, or, for sequence-
  sharded keys, on its keys with the softmax's max and sums and P·V
  reduced over the model axis (:func:`_attention_on_shards`).  The
  one-device code path is untouched by it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (P, all_reduce, current_rules,
                                             from_local, gathered_numel,
                                             local_shards,
                                             mesh_coordinate, shard)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ---------------------------------------------------------------------------
# small utils
# ---------------------------------------------------------------------------


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}: one of "
                         f"{sorted(_DTYPES)}") from None


def cdtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def pdtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Uniform in ±1/√fan_in, on the generator's device."""
    fan_in = shape[in_axis]
    scale = 1.0 / math.sqrt(fan_in)
    u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                   dtype=dtype)
    return u * (2.0 * scale) - scale


def rms_norm(x, w, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def norm_apply(cfg, params, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


def norm_spec(cfg):
    if cfg.norm == "rmsnorm":
        return {"scale": P()}
    return {"scale": P(), "bias": P()}


def norm_init(cfg, gen: torch.Generator):
    kw = dict(dtype=pdtype(cfg), device=gen.device)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((cfg.d_model,), **kw)}
    return {"scale": torch.ones((cfg.d_model,), **kw),
            "bias": torch.zeros((cfg.d_model,), **kw)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float):
    """In float64 numpy, as the reference computes them (a float32
    ``theta ** (arange / d)`` gives other frequencies at θ = 500000)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # one upload per (width, θ, device): a host→device copy per call
    # would also wait for the device on every layer
    return torch.as_tensor(rope_freqs(head_dim, theta).astype(np.float32),
                           device=device)


def rope_table(pos, head_dim: int, theta: float):
    """(cos, sin) of the angles at ``pos`` (broadcastable to (..., S)),
    shaped (..., S, 1, D/2) to broadcast over heads.  A decode step
    builds it once for every layer."""
    angles = pos[..., None].float() * _rope_freqs_on(head_dim, theta,
                                                     pos.device)
    angles = angles[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, pos, theta: float, *, table=None):
    """x: (..., S, H, D); pos: broadcastable to (..., S); ``table``: a
    :func:`rope_table` of ``pos`` made beforehand."""
    cos, sin = rope_table(pos, x.shape[-1], theta) if table is None else table
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def kv_repeat_factor(cfg) -> int:
    """Smallest r with (kv·r) % tp == 0 and heads % (kv·r) == 0, else 1."""
    rules = current_rules()
    axes = rules.axes_for("heads")
    tp = rules.mesh_size(axes) if axes else 1
    kv, h = cfg.n_kv_heads, cfg.n_heads
    if tp <= 1 or kv % tp == 0:
        return 1
    r = 1
    while kv * r < max(tp, h) + 1:
        if (kv * r) % tp == 0 and h % (kv * r) == 0:
            return r
        r += 1
    return 1  # fall back to replication


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_q: int       # query heads
    n_kv: int      # stored KV heads (after repeat)
    group: int     # queries per stored KV head
    head_dim: int


def attn_dims(cfg) -> AttnDims:
    rep = kv_repeat_factor(cfg)
    n_kv = cfg.n_kv_heads * rep
    return AttnDims(cfg.n_heads, n_kv, cfg.n_heads // n_kv, cfg.head_dim_)


def kv_heads_shardable(cfg) -> bool:
    """True if the (repeated) KV head count divides the TP axis."""
    rules = current_rules()
    axes = rules.axes_for("kv_heads")
    tp = rules.mesh_size(axes) if axes else 1
    return tp <= 1 or attn_dims(cfg).n_kv % tp == 0


def divisor_chunk(s: int, target: int) -> int:
    """Largest chunk ≤ target that divides s."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def attention_init(cfg, gen: torch.Generator):
    d, hd = cfg.d_model, cfg.head_dim_
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd)),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wo": dense_init(gen, (cfg.n_heads * hd, d)),
    }
    if cfg.qkv_bias:
        kw = dict(dtype=pdtype(cfg), device=gen.device)
        p["bq"] = torch.zeros((cfg.n_heads * hd,), **kw)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), **kw)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), **kw)
    return p


def attention_spec(cfg):
    s = {
        "wq": P("fsdp", "model"),
        "wk": P("fsdp", "model"),
        "wv": P("fsdp", "model"),
        "wo": P("model", "fsdp"),
    }
    if cfg.qkv_bias:
        s.update({"bq": P("model"), "bk": P("model"), "bv": P("model")})
    return s


def _project_qkv(cfg, params, x, pos, rope: bool = True, *,
                 rope_table=None):
    """x: (B,S,D) → q (B,S,Hq,hd), k/v (B,S,Hkv_eff,hd) with the GQA
    repeat (:func:`attn_dims`).  q and k are rotated
    in one pass (RoPE is elementwise); ``rope_table`` is the
    :func:`rope_table` of ``pos`` when the caller made it already."""
    dims = attn_dims(cfg)
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    B, S = x.shape[:2]
    q = q.reshape(B, S, dims.n_q, dims.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, dims.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, dims.head_dim)
    if rope and cfg.pos_embed == "rope":
        qk = apply_rope(torch.cat([q, k], dim=2), pos, cfg.rope_theta,
                        table=rope_table)
        q, k = qk.split([dims.n_q, cfg.n_kv_heads], dim=2)
    rep = dims.n_kv // cfg.n_kv_heads
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    q = shard(q, "batch", "seq", "heads", None)
    if kv_heads_shardable(cfg):
        k = shard(k, "batch", "seq", "kv_heads", None)
        v = shard(v, "batch", "seq", "kv_heads", None)
    else:  # MHA-ish archs on a wider TP axis: sequence-sharded KV
        k = shard(k, "batch", "model", None, None)
        v = shard(v, "batch", "model", None, None)
    return q, k, v


def _chunk_attend(q_c, k, v, q_pos, k_pos, window: int):
    """One query chunk against a key range. Shapes:
    q_c (B,C,Hkv,G,hd); k,v (B,T,Hkv,hd); q_pos (C,), k_pos (T,).
    Causal + optional window mask. fp32 softmax; the probabilities are
    cast to the compute dtype before P·V, which accumulates in fp32."""
    scale = 1.0 / math.sqrt(q_c.shape[-1])
    scores = torch.einsum("bckgd,btkd->bkgct", q_c.float(), k.float()) * scale
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = torch.where(mask[None, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgct,btkd->bckgd", probs.to(q_c.dtype).float(),
                       v.float())
    return out.to(q_c.dtype)


def full_attention(cfg, q, k, v, *, pos0: int = 0):
    """Causal (optionally windowed) attention over a full sequence, row-
    chunked over queries. q: (B,S,Hq,hd) → (B,S,Hq*hd).  On a mesh it
    runs on each rank's shards (:func:`_attention_on_shards`)."""
    shards = _attention_on_shards(q, k, v)
    if shards is not None:
        return _full_attention_on_shards(cfg, *shards, pos0=pos0)
    return _full_attention(cfg, q, k, v, pos0)


def _full_attention(cfg, q, k, v, pos0):
    """:func:`full_attention` on plain tensors, whose head counts are
    read from the shapes (a rank's shards hold some of the heads)."""
    B, S, n_q, hd = q.shape
    n_kv = k.shape[2]
    C = divisor_chunk(S, cfg.q_chunk)
    qg = q.reshape(B, S, n_kv, n_q // n_kv, hd)
    dev = q.device
    win = cfg.window
    outs = []
    for i in range(S // C):
        q_c = qg[:, i * C:(i + 1) * C]
        q_pos = pos0 + i * C + torch.arange(C, device=dev)
        if win > 0 and win % C == 0 and S > win:
            # local attention: only the needed key range per chunk
            k0 = max(i * C - win, 0)
            span = win + C
            k_c, v_c = k[:, k0:k0 + span], v[:, k0:k0 + span]
            k_pos = pos0 + k0 + torch.arange(k_c.shape[1], device=dev)
            outs.append(_chunk_attend(q_c, k_c, v_c, q_pos, k_pos, win))
        else:
            k_pos = pos0 + torch.arange(S, device=dev)
            outs.append(_chunk_attend(q_c, k, v, q_pos, k_pos, win))
    out = torch.cat(outs, dim=1)
    return out.reshape(B, S, n_q * hd)


def decode_attention(cfg, q, k_cache, v_cache, kv_len, *, apply_window=True):
    """Single-token attention. q: (B,1,Hq,hd); caches (B,Smax,Hkv,hd);
    kv_len: (B,) valid lengths (new token already written).
    ``apply_window=False`` for ring-buffer caches whose slots are already
    window-resident.  On a mesh it runs on each rank's shards
    (:func:`_attention_on_shards`)."""
    window = cfg.window if apply_window else 0
    shards = _attention_on_shards(q, k_cache, v_cache)
    if shards is not None:
        return _decode_attention_on_shards(*shards, kv_len, window)
    dims = attn_dims(cfg)
    B = q.shape[0]
    Smax = k_cache.shape[1]
    qg = q.reshape(B, 1, dims.n_kv, dims.group, dims.head_dim)
    scale = 1.0 / math.sqrt(dims.head_dim)
    scores = torch.einsum("bckgd,btkd->bkgct", qg.float(),
                          k_cache.float()) * scale  # (B,Hkv,G,1,Smax)
    t = torch.arange(Smax, device=q.device)
    kv_len = kv_len.to(q.device)
    mask = t[None, :] < kv_len[:, None]  # (B,Smax)
    if window > 0:
        mask &= t[None, :] >= kv_len[:, None] - window
    scores = torch.where(mask[:, None, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgct,btkd->bckgd", probs.to(q.dtype).float(),
                       v_cache.float()).to(q.dtype)
    return out.reshape(B, 1, dims.n_q * dims.head_dim)


# ---------------------------------------------------------------------------
# attention on a mesh: each rank on its shards
# ---------------------------------------------------------------------------


def _attention_on_shards(q, k, v):
    """None for plain tensors.  For DTensors: ``(mesh, q, k, v, seq)``,
    the three laid out so that each rank attends on its own shards, as
    GSPMD partitions the reference's einsums and softmax.  Per mesh dim,
    q, k and v share k's layout of the batch (dim 0) and heads (dim 2),
    which keeps a rank's query heads with their KV heads; where k's
    sequence (dim 1) is sharded (a KV head count the model axis does not
    divide), q is whole there and ``seq`` names those mesh dims: each
    rank scores its keys, and a max and sums over them combine the ranks'
    softmax and products."""
    if not hasattr(k, "device_mesh"):
        return None
    from torch.distributed.tensor import Replicate

    mesh = k.device_mesh
    kv_want, q_want, seq = [], [], []
    for i, p in enumerate(k.placements):
        if p.is_shard() and p.dim == 1:
            seq.append(i)
            kv_want.append(p)
            q_want.append(Replicate())
        elif p.is_shard() and p.dim in (0, 2):
            kv_want.append(p)
            q_want.append(p)
        else:
            kv_want.append(Replicate())
            q_want.append(Replicate())

    def fit(x, want):
        return (x if list(x.placements) == want
                else x.redistribute(mesh, want))

    return mesh, fit(q, q_want), fit(k, kv_want), fit(v, kv_want), seq


def _reduce_over(mesh, seq):
    """An all-reduce over the sequence's mesh dims (:func:`all_reduce`)."""
    return lambda t, op="sum", per_rank_use=False: all_reduce(
        t, mesh, seq, op, per_rank_use=per_rank_use)


def _softmax_over_shards(scores, reduce):
    """softmax over the last dim of scores whose last dim lies in shards
    across ranks: a max and a sum over the ranks (each rank divides its
    own scores by the sum)."""
    m = reduce(torch.amax(scores, dim=-1, keepdim=True).detach(), "max")
    e = torch.exp(scores - m)
    return e / reduce(torch.sum(e, dim=-1, keepdim=True), per_rank_use=True)


def _full_attention_on_shards(cfg, mesh, q, k, v, seq, *, pos0):
    """:func:`full_attention` on each rank's shards; with the keys in
    shards (``seq``), each query chunk scores this rank's keys at their
    global positions, and the probabilities' max, sums and P·V are
    reduced over the ranks.  Where the reference slices a windowed
    chunk's ``window + C`` keys, a rank scores only its keys inside that
    span; a rank with none of them scores one key fully masked, and so
    adds to the max, sums and P·V -1e30, 0 and 0."""
    B, S, n_q, hd = q.shape
    ql, kl, vl = local_shards(q, k, v, partial=seq)
    if not seq:
        out = _full_attention(cfg, ql, kl, vl, pos0)
    else:
        reduce = _reduce_over(mesh, seq)
        Bl, _, Hl, _ = ql.shape
        T = kl.shape[1]
        r0 = mesh_coordinate(mesh, seq) * T  # this rank's first key
        n_kv = kl.shape[2]
        C = divisor_chunk(S, cfg.q_chunk)
        win = cfg.window
        local = win > 0 and win % C == 0 and S > win
        qg = ql.reshape(Bl, S, n_kv, Hl // n_kv, hd)
        scale = 1.0 / math.sqrt(hd)
        outs = []
        for i in range(S // C):
            q_c = qg[:, i * C:(i + 1) * C]
            q_pos = pos0 + i * C + torch.arange(C, device=ql.device)
            a, b = r0, r0 + T  # this rank's keys the chunk may see
            if local:
                k0 = max(i * C - win, 0)
                a, b = max(a, k0), min(b, k0 + win + C)
            empty = b <= a
            if empty:
                # one key, all of it masked: the same ops (and the same
                # collectives, forward and backward) as every other rank
                a, b = r0, r0 + 1
            k_c, v_c = kl[:, a - r0:b - r0], vl[:, a - r0:b - r0]
            k_pos = pos0 + a + torch.arange(b - a, device=ql.device)
            scores = torch.einsum("bckgd,btkd->bkgct", q_c.float(),
                                  k_c.float()) * scale
            mask = k_pos[None, :] <= q_pos[:, None]
            if win > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - win
            if empty:
                mask &= False
            scores = torch.where(mask[None, None, None], scores,
                                 torch.full_like(scores, -1e30))
            probs = _softmax_over_shards(scores, reduce)
            o = torch.einsum("bkgct,btkd->bckgd",
                             probs.to(q_c.dtype).float(), v_c.float())
            outs.append(reduce(o).to(q_c.dtype))
        out = torch.cat(outs, dim=1).reshape(Bl, S, Hl * hd)
    return from_local(out, mesh, q.placements, (B, S, n_q * hd))


def _decode_attention_on_shards(mesh, q, k, v, seq, kv_len, window):
    """:func:`decode_attention` on each rank's shards.  Each cache row is
    widened to float32 on its own (no float32 copy of a whole cache);
    with the keys in shards (``seq``), the probabilities' max, sums and
    P·V are reduced over the ranks."""
    B, _, n_q, hd = q.shape
    ql, kl, vl = local_shards(q, k, v)
    Bl, _, Hl, _ = ql.shape
    T, n_kv = kl.shape[1], kl.shape[2]
    reduce = _reduce_over(mesh, seq)
    qg = ql.reshape(Bl, 1, n_kv, Hl // n_kv, hd).float()
    scale = 1.0 / math.sqrt(hd)
    scores = torch.cat([
        torch.einsum("bckgd,btkd->bkgct", qg[b:b + 1],
                     kl[b:b + 1].float()) for b in range(Bl)]) * scale
    t = mesh_coordinate(mesh, seq) * T + torch.arange(T, device=ql.device)
    (kv_len,) = local_shards(kv_len)
    kv_len = kv_len.to(ql.device)
    mask = t[None, :] < kv_len[:, None]  # (Bl, T)
    if window > 0:
        mask &= t[None, :] >= kv_len[:, None] - window
    scores = torch.where(mask[:, None, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = _softmax_over_shards(scores, reduce).to(ql.dtype)
    out = torch.cat([
        torch.einsum("bkgct,btkd->bckgd", probs[b:b + 1].float(),
                     vl[b:b + 1].float()) for b in range(Bl)])
    out = reduce(out).to(ql.dtype).reshape(Bl, 1, Hl * hd)
    return from_local(out, mesh, q.placements, (B, 1, n_q * hd))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(cfg, gen: torch.Generator, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_in": dense_init(gen, (d, f)),
            "w_gate": dense_init(gen, (d, f)),
            "w_out": dense_init(gen, (f, d)),
        }
    kw = dict(dtype=pdtype(cfg), device=gen.device)
    return {
        "w_in": dense_init(gen, (d, f)),
        "b_in": torch.zeros((f,), **kw),
        "w_out": dense_init(gen, (f, d)),
        "b_out": torch.zeros((d,), **kw),
    }


def mlp_spec(cfg):
    if cfg.act in ("swiglu", "geglu"):
        return {"w_in": P("fsdp", "model"), "w_gate": P("fsdp", "model"),
                "w_out": P("model", "fsdp")}
    return {"w_in": P("fsdp", "model"), "b_in": P("model"),
            "w_out": P("model", "fsdp"), "b_out": P()}


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg, params, x):
    dt = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        act = F.silu if cfg.act == "swiglu" else _gelu
        h = act(x @ params["w_gate"].to(dt)) * (x @ params["w_in"].to(dt))
        h = shard(h, "batch", "seq", "ff")
        return h @ params["w_out"].to(dt)
    h = _gelu(x @ params["w_in"].to(dt) + params["b_in"].to(dt))
    h = shard(h, "batch", "seq", "ff")
    return h @ params["w_out"].to(dt) + params["b_out"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------


def embed_init(cfg, gen: torch.Generator, dtype=torch.float32):
    """Each table is cast to ``dtype`` as soon as it is made, so a
    full-width init holds one float32 table at a time."""
    p = {"table": (dense_init(gen, (cfg.vocab, cfg.d_model))
                   * (0.02 * math.sqrt(cfg.d_model))).to(dtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab)).to(dtype)
    if cfg.pos_embed == "learned":
        # sized generously so long decode positions fit
        p["pos"] = (dense_init(gen, (65536, cfg.d_model)) * 0.02).to(dtype)
    return p


def embed_spec(cfg):
    s = {"table": P("model", "fsdp")}
    if not cfg.tie_embeddings:
        s["head"] = P("fsdp", "model")
    if cfg.pos_embed == "learned":
        s["pos"] = P(None, "fsdp")
    return s


def embed_tokens(cfg, params, tokens, pos=None):
    x = params["table"][tokens.long()].to(cdtype(cfg))
    if cfg.pos_embed == "learned" and pos is not None:
        x = x + params["pos"][pos.long()].to(cdtype(cfg))
    return shard(x, "batch", "res_seq", "dmodel")


def lm_logits(cfg, params, x, on_shards: bool = False):
    """``x @`` the head, laid out as the reference's logits; with
    ``on_shards`` (a mesh whose batch and sequence both lie in shards)
    on each rank's shards (:func:`_logits_on_shards`)."""
    if cfg.tie_embeddings:
        w = params["table"].to(x.dtype).T
    else:
        w = params["head"].to(x.dtype)
    y = _logits_on_shards(x, w) if on_shards else x @ w
    return shard(y, "batch", "seq", "vocab")


def _logits_on_shards(x, w):
    """``x @ w`` for DTensors x (B, C, D) and w (D, V) on each rank's
    shards.  ``w`` is gathered where its rows (FSDP shards) lie in
    shards; on the mesh dims holding both x's sequence and w's vocabulary
    in shards, the operand whose gathered shard is the smaller is
    gathered, as GSPMD settles such a clash (the measure of the dry-run's
    rule for other products, ``gathered_numel``).  The product never
    merges x's batch and sequence into one dim, a layout torch 2.11's
    DTensor cannot view (it would gather the sequence, and every rank of
    the model axis would compute all of it)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    px = list(x.placements)
    pw = [Replicate() if p.is_shard() and p.dim == 0 else p
          for p in w.placements]
    clash = [i for i in range(mesh.ndim)
             if px[i].is_shard() and pw[i].is_shard()]
    if clash:
        small = px if (gathered_numel(x, px, clash)
                       < gathered_numel(w, pw, clash)) else pw
        for i in clash:
            small[i] = Replicate()
    x, w = x.redistribute(mesh, px), w.redistribute(mesh, pw)
    # a replicated operand is put to a use of each rank's own
    (xl,) = local_shards(x, partial=[i for i in range(mesh.ndim)
                                     if pw[i].is_shard()])
    (wl,) = local_shards(w, partial=[i for i in range(mesh.ndim)
                                     if px[i].is_shard()])
    out = [p if p.is_shard() else (Shard(2) if q.is_shard() else Replicate())
           for p, q in zip(px, pw)]
    return from_local(xl @ wl, mesh, out, (x.shape[0], x.shape[1],
                                          w.shape[1]))


def _seq_shards(x) -> int:
    """The number of shards a DTensor's dim 1 lies in (1 for a plain
    tensor)."""
    if not hasattr(x, "device_mesh"):
        return 1
    return math.prod(x.device_mesh.shape[i]
                     for i, p in enumerate(x.placements)
                     if p.is_shard() and p.dim == 1)


def xent_loss(cfg, params, hidden, labels, *, chunk: int = 512,
              remat: bool = True):
    """Sequence-chunked softmax cross-entropy in float32 (keeps (B,C,V)
    logits bounded).  hidden: (B,S,D); labels: (B,S) with -100 = ignore.
    With ``remat``, more than one chunk and grad mode on, each chunk's
    logits are recomputed in the backward pass rather than kept, as the
    reference's ``jax.checkpoint(piece)``."""
    B, S, _ = hidden.shape
    C = divisor_chunk(S, chunk)
    n = S // C
    m = _seq_shards(hidden)
    on_seq_shards = m > 1 and C % m == 0

    def piece(h_c, y_c):
        logits = lm_logits(cfg, params, h_c, on_shards=on_seq_shards).float()
        lse = torch.logsumexp(logits, dim=-1)
        # the gold logit as a masked sum over the vocab (exact: one term
        # is not zero), which stays local to each shard of a vocab-sharded
        # DTensor, where a gather's backward would build the whole
        # (B, C, V) gradient on every rank
        hit = torch.arange(logits.shape[-1], device=y_c.device) \
            == torch.clamp_min(y_c, 0).long()[..., None]
        gold = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
        valid = (y_c >= 0).float()
        return torch.sum((lse - gold) * valid), torch.sum(valid)

    remat = remat and n > 1 and torch.is_grad_enabled()
    if on_seq_shards:
        # on a mesh with the sequence in m shards (the residual's sequence
        # parallelism): a chunk takes C / m tokens of every shard, so its
        # rows stay on their ranks (the loss sums every token either way)
        hidden = hidden.reshape(B, m, S // m, hidden.shape[-1])
        labels = labels.reshape(B, m, S // m)

        def take(t, i):
            c = C // m
            return t[:, :, i * c:(i + 1) * c].reshape(
                (B, C) + tuple(t.shape[3:]))
    else:
        def take(t, i):
            return t[:, i * C:(i + 1) * C]
    tot = cnt = 0.0
    for i in range(n):
        h_c, y_c = take(hidden, i), take(labels, i)
        l, c = (checkpoint(piece, h_c, y_c, use_reentrant=False) if remat
                else piece(h_c, y_c))
        tot, cnt = tot + l, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)
