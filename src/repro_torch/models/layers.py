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

from repro_torch.distributed.sharding import P, current_rules, shard

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
    chunked over queries. q: (B,S,Hq,hd) → (B,S,Hq*hd)."""
    dims = attn_dims(cfg)
    B, S = q.shape[:2]
    C = divisor_chunk(S, cfg.q_chunk)
    qg = q.reshape(B, S, dims.n_kv, dims.group, dims.head_dim)
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
    return out.reshape(B, S, dims.n_q * dims.head_dim)


def decode_attention(cfg, q, k_cache, v_cache, kv_len, *, apply_window=True):
    """Single-token attention. q: (B,1,Hq,hd); caches (B,Smax,Hkv,hd);
    kv_len: (B,) valid lengths (new token already written).
    ``apply_window=False`` for ring-buffer caches whose slots are already
    window-resident."""
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
    if cfg.window > 0 and apply_window:
        mask &= t[None, :] >= kv_len[:, None] - cfg.window
    scores = torch.where(mask[:, None, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgct,btkd->bckgd", probs.to(q.dtype).float(),
                       v_cache.float()).to(q.dtype)
    return out.reshape(B, 1, dims.n_q * dims.head_dim)


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


def lm_logits(cfg, params, x):
    if cfg.tie_embeddings:
        w = params["table"].to(x.dtype).T
    else:
        w = params["head"].to(x.dtype)
    return shard(x @ w, "batch", "seq", "vocab")


def xent_loss(cfg, params, hidden, labels, *, chunk: int = 512):
    """Sequence-chunked softmax cross-entropy in float32 (keeps (B,C,V)
    logits bounded).  hidden: (B,S,D); labels: (B,S) with -100 = ignore.
    With more than one chunk and grad mode on, each chunk's logits are
    recomputed in the backward pass rather than kept, as the reference's
    ``jax.checkpoint(piece)``."""
    B, S, _ = hidden.shape
    C = divisor_chunk(S, chunk)
    n = S // C

    def piece(h_c, y_c):
        logits = lm_logits(cfg, params, h_c).float()
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

    remat = n > 1 and torch.is_grad_enabled()
    tot = cnt = 0.0
    for i in range(n):
        h_c, y_c = hidden[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
        l, c = (checkpoint(piece, h_c, y_c, use_reentrant=False) if remat
                else piece(h_c, y_c))
        tot, cnt = tot + l, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)
