"""Transformer layer blocks on torch: the KV-cache helpers, the dense
GQA decoder layer (llama / yi / command-r / qwen, and the VLM backbone),
the bidirectional encoder and cross-attention decoder layers (whisper),
and the sort-based MoE FFN with its layer (granite / qwen3-moe).

Block protocol (the JAX package's, ``src/repro/models/blocks.py``): a
block is a namespace of functions

  init(cfg, gen) -> params            one layer's params (float32)
  spec(cfg) -> dict of logical partition specs (:class:`P`)
  init_cache(cfg, batch, max_len, device) -> cache dict
  cache_spec(cfg) -> the cache's specs
  apply(cfg, params, x, *, mode, cache, pos, extras) -> (x, new_cache)

``mode`` ∈ {"train", "prefill", "decode"}; ``pos`` is (B,) — the
position being generated in decode.  Train mode is prefill without the
cache (``new_cache`` None).  Caches are returned as new tensors (the
reference threads functional arrays), unless a decode step is given
``extras={"donate": True}``: then it writes the caches it was given in
place and returns them, as the reference's jit does with donated
caches (:func:`donated`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (P, current_rules, from_local,
                                             local_shards, mesh_coordinate,
                                             shard)

from . import layers as L

MODES = ("train", "prefill", "decode")

# ---------------------------------------------------------------------------
# KV cache helpers
# ---------------------------------------------------------------------------


def kv_cache_init(cfg, batch: int, max_len: int, device=None):
    dims = L.attn_dims(cfg)
    length = min(max_len, cfg.window) if cfg.window > 0 else max_len
    shape = (batch, length, dims.n_kv, dims.head_dim)
    return {"k": torch.zeros(shape, dtype=L.cdtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=L.cdtype(cfg), device=device)}


def kv_cache_spec(cfg):
    """Head-sharded when possible; otherwise sequence-sharded over the
    model axis (MHA archs like qwen1.5 (40 heads) / whisper (20) cannot
    head-shard on 16)."""
    if L.kv_heads_shardable(cfg):
        s = P("batch", None, "kv_heads", None)
    else:
        s = P("batch", "model", None, None)
    return {"k": s, "v": s}


def _ring_fill(x, w):
    """Fill a ring buffer of length w from a full sequence (B,S,...):
    slot s gets the *last* position p < S with p % w == s."""
    S = x.shape[1]
    slot = torch.arange(w, device=x.device)
    p = slot + w * torch.div(S - 1 - slot, w, rounding_mode="floor")
    p = torch.clamp(p, 0, S - 1)
    return x[:, p]


def build_prefill_cache(cfg, k, v, max_len):
    """A fresh KV cache from full-sequence K/V."""
    dt = L.cdtype(cfg)
    S = k.shape[1]
    if cfg.window > 0:
        w = min(cfg.window, max_len)
        return {"k": _ring_fill(k, w).to(dt), "v": _ring_fill(v, w).to(dt)}
    if S == max_len:
        return {"k": k.to(dt), "v": v.to(dt)}
    B = k.shape[0]
    shape = (B, max_len) + tuple(k.shape[2:])
    kc = torch.zeros(shape, dtype=dt, device=k.device)
    vc = torch.zeros(shape, dtype=dt, device=k.device)
    kc[:, :S] = k.to(dt)
    vc[:, :S] = v.to(dt)
    return {"k": kc, "v": vc}


def _cache_write_token(cfg, cache, k_new, v_new, pos, *, donate=False):
    """Write one token at pos (B,) — rolling ring buffer if windowed.  A
    scatter along the sequence (each row's own slot), which keeps a
    cache sharded on its batch and head dims local to each shard.  With
    ``donate`` the token is written into the caches given, which are
    returned (the reference's donated caches); on a mesh each rank
    writes its own shard (:func:`_write_token_on_shards`)."""
    pos = pos.long()
    slot = pos % cache["k"].shape[1] if cfg.window > 0 else pos
    if donate:
        for name, new in (("k", k_new), ("v", v_new)):
            _write_token(cache[name], new, slot)
        return {"k": cache["k"], "v": cache["v"]}
    idx = slot.view(-1, 1, 1, 1).expand(k_new.shape)
    k = cache["k"].scatter(1, idx, k_new.to(cache["k"].dtype))
    v = cache["v"].scatter(1, idx, v_new.to(cache["v"].dtype))
    return {"k": k, "v": v}


def _write_token(cache, new, slot):
    """``cache[b, slot[b]] = new[b, 0]`` in place, for every row b."""
    if not hasattr(cache, "device_mesh"):
        idx = slot.view(-1, 1, 1, 1).expand(new.shape)
        cache.scatter_(1, idx, new.to(cache.dtype))
        return
    _write_token_on_shards(cache, new, slot)


def _write_token_on_shards(cache, new, slot):
    """:func:`_write_token` on a DTensor cache, each rank on its shard:
    the token and the slots are laid out as the cache's batch and heads;
    where the cache's sequence is sharded, a rank writes the rows whose
    slot lies in its shard and writes the others' own values back."""
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    seq = [i for i, p in enumerate(cache.placements)
           if p.is_shard() and p.dim == 1]
    want = [Replicate() if i in seq else p
            for i, p in enumerate(cache.placements)]
    new = new.to(cache.dtype)
    if list(new.placements) != want:
        new = new.redistribute(mesh, want)
    slot_want = [p if p.is_shard() and p.dim == 0 else Replicate()
                 for p in cache.placements]
    if list(slot.placements) != slot_want:
        slot = slot.redistribute(mesh, slot_want)
    cl, nl, sl = local_shards(cache, new, slot)
    T = cl.shape[1]
    sl = sl - mesh_coordinate(mesh, seq) * T
    idx = torch.clamp(sl, 0, T - 1).view(-1, 1, 1, 1).expand(nl.shape)
    if seq:
        mine = ((sl >= 0) & (sl < T)).view(-1, 1, 1, 1)
        nl = torch.where(mine, nl, torch.gather(cl, 1, idx))
    cl.scatter_(1, idx, nl)


def donated(extras) -> bool:
    """Whether a decode step writes its caches in place
    (``extras["donate"]``, :meth:`~repro_torch.models.model_api.Model.decode_step`)."""
    return bool(extras and extras.get("donate"))


def _check_mode(block: str, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"{block} mode {mode!r}: one of {MODES}")


def _decode_self_attention(cfg, q, cache, pos):
    """Self-attention against the cache.  Windowed archs use a ring
    buffer: every stored slot is inside the window by construction, so
    only validity is masked."""
    kv_len = pos + 1  # tokens written so far
    if cfg.window > 0:
        win = cache["k"].shape[1]
        valid = torch.clamp(kv_len, max=win)
        return L.decode_attention(cfg, q, cache["k"], cache["v"], valid,
                                  apply_window=False)
    return L.decode_attention(cfg, q, cache["k"], cache["v"], kv_len)


def _self_attention(cfg, params, h, *, mode, cache, pos, extras,
                    rope: bool = True):
    """A decoder block's causal self-attention on its normed input ``h``:
    (the attention's output (B,S,Hq*hd) before ``wo``, the new KV cache).
    Decode writes one token into ``cache``; prefill builds a fresh cache
    of ``extras["max_len"]``; train builds none and returns ``cache``."""
    if mode == "decode":
        q, k, v = L._project_qkv(cfg, params, h, pos[:, None], rope)
        cache = _cache_write_token(cfg, cache, k, v, pos,
                                   donate=donated(extras))
        return _decode_self_attention(cfg, q, cache, pos), cache
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    q, k, v = L._project_qkv(cfg, params, h, positions, rope)
    if mode == "prefill":
        cache = build_prefill_cache(cfg, k, v, extras["max_len"])
    return L.full_attention(cfg, q, k, v), cache


# ---------------------------------------------------------------------------
# Dense decoder layer (attn + MLP) — llama/yi/command-r/qwen + VLM backbone
# ---------------------------------------------------------------------------


class DenseLayer:
    #: leaves held in float32 whatever the compute dtype (none here;
    #: see :mod:`repro_torch.models.recurrent`)
    FLOAT32 = ()

    @staticmethod
    def init(cfg, gen: torch.Generator):
        return {
            "norm1": L.norm_init(cfg, gen),
            "attn": L.attention_init(cfg, gen),
            "norm2": L.norm_init(cfg, gen),
            "mlp": L.mlp_init(cfg, gen),
        }

    @staticmethod
    def spec(cfg):
        return {
            "norm1": L.norm_spec(cfg),
            "attn": L.attention_spec(cfg),
            "norm2": L.norm_spec(cfg),
            "mlp": L.mlp_spec(cfg),
        }

    @staticmethod
    def init_cache(cfg, batch, max_len, device=None):
        return kv_cache_init(cfg, batch, max_len, device)

    @staticmethod
    def cache_spec(cfg):
        return kv_cache_spec(cfg)

    @staticmethod
    def apply(cfg, params, x, *, mode, cache=None, pos=None, extras=None):
        _check_mode("DenseLayer", mode)
        h = L.norm_apply(cfg, params["norm1"], x)
        attn, cache = _self_attention(cfg, params["attn"], h, mode=mode,
                                      cache=cache, pos=pos, extras=extras)
        x = x + attn @ params["attn"]["wo"].to(x.dtype)
        x = shard(x, "batch", "res_seq", "dmodel")
        h = L.norm_apply(cfg, params["norm2"], x)
        x = x + L.mlp_apply(cfg, params["mlp"], h)
        return shard(x, "batch", "res_seq", "dmodel"), cache


def _attend(q, k, v, dims):
    """Unmasked GQA attention, a single-shot float32 softmax: q
    (B,S,Hq,hd), k, v (B,T,Hkv,hd) → (B,S,Hq*hd) in q's dtype; the
    probabilities are cast to the compute dtype before P·V, as the
    reference casts them."""
    B, S = q.shape[:2]
    qg = q.reshape(B, S, dims.n_kv, dims.group, dims.head_dim)
    scale = 1.0 / math.sqrt(dims.head_dim)
    scores = torch.einsum("bckgd,btkd->bkgct", qg.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgct,btkd->bckgd", probs.to(q.dtype).float(),
                       v.float()).to(q.dtype)
    return out.reshape(B, S, dims.n_q * dims.head_dim)


# ---------------------------------------------------------------------------
# Bidirectional encoder layer (whisper encoder)
# ---------------------------------------------------------------------------


class EncoderLayer:
    """The dense layer's params, attention over the whole sequence with
    no mask and no rope; it keeps no cache."""

    FLOAT32 = ()
    init = staticmethod(DenseLayer.init)
    spec = staticmethod(DenseLayer.spec)

    @staticmethod
    def init_cache(cfg, batch, max_len, device=None):
        return {}

    @staticmethod
    def cache_spec(cfg):
        return {}

    @staticmethod
    def apply(cfg, params, x, *, mode, cache=None, pos=None, extras=None):
        _check_mode("EncoderLayer", mode)
        h = L.norm_apply(cfg, params["norm1"], x)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q, k, v = L._project_qkv(cfg, params["attn"], h, positions,
                                 rope=False)
        attn = _attend(q, k, v, L.attn_dims(cfg))
        x = x + attn @ params["attn"]["wo"].to(x.dtype)
        h = L.norm_apply(cfg, params["norm2"], x)
        x = x + L.mlp_apply(cfg, params["mlp"], h)
        return shard(x, "batch", "res_seq", "dmodel"), cache


# ---------------------------------------------------------------------------
# Cross-attention decoder layer (whisper decoder)
# ---------------------------------------------------------------------------


class CrossLayer:
    """Causal self-attention (learned positions, no rope), cross-attention
    over the encoder's output, MLP.  The cache adds ``xk``/``xv``, the
    encoder output's keys and values: prefill builds them from
    ``extras["enc"]``, decode reads them."""

    FLOAT32 = ()

    @staticmethod
    def init(cfg, gen: torch.Generator):
        return {
            "norm1": L.norm_init(cfg, gen),
            "attn": L.attention_init(cfg, gen),
            "norm_x": L.norm_init(cfg, gen),
            "xattn": L.attention_init(cfg, gen),
            "norm2": L.norm_init(cfg, gen),
            "mlp": L.mlp_init(cfg, gen),
        }

    @staticmethod
    def spec(cfg):
        return {
            "norm1": L.norm_spec(cfg),
            "attn": L.attention_spec(cfg),
            "norm_x": L.norm_spec(cfg),
            "xattn": L.attention_spec(cfg),
            "norm2": L.norm_spec(cfg),
            "mlp": L.mlp_spec(cfg),
        }

    @staticmethod
    def init_cache(cfg, batch, max_len, device=None):
        c = kv_cache_init(cfg, batch, max_len, device)
        dims = L.attn_dims(cfg)
        xshape = (batch, cfg.enc_seq, dims.n_kv, dims.head_dim)
        c["xk"] = torch.zeros(xshape, dtype=L.cdtype(cfg), device=device)
        c["xv"] = torch.zeros(xshape, dtype=L.cdtype(cfg), device=device)
        return c

    @staticmethod
    def cache_spec(cfg):
        s = kv_cache_spec(cfg)
        s["xk"] = P("batch", None, "kv_heads", None)
        s["xv"] = P("batch", None, "kv_heads", None)
        return s

    @staticmethod
    def _cross_kv(cfg, params, enc):
        """The encoder output's keys and values (B,T,Hkv_eff,hd), with
        the GQA repeat."""
        dims = L.attn_dims(cfg)
        dt = enc.dtype
        B, T = enc.shape[:2]
        k = (enc @ params["wk"].to(dt)).reshape(B, T, cfg.n_kv_heads,
                                                dims.head_dim)
        v = (enc @ params["wv"].to(dt)).reshape(B, T, cfg.n_kv_heads,
                                                dims.head_dim)
        rep = dims.n_kv // cfg.n_kv_heads
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        return k, v

    @staticmethod
    def apply(cfg, params, x, *, mode, cache=None, pos=None, extras=None):
        _check_mode("CrossLayer", mode)
        B, S = x.shape[:2]
        dt = x.dtype
        dims = L.attn_dims(cfg)
        # -- causal self attention ---------------------------------------
        h = L.norm_apply(cfg, params["norm1"], x)
        if mode == "decode":
            q, k, v = L._project_qkv(cfg, params["attn"], h, pos[:, None],
                                     rope=False)
            cache = dict(cache)
            cache.update(_cache_write_token(
                cfg, {"k": cache["k"], "v": cache["v"]}, k, v, pos,
                donate=donated(extras)))
            attn = L.decode_attention(cfg, q, cache["k"], cache["v"],
                                      pos + 1)
        else:
            attn, cache = _self_attention(cfg, params["attn"], h, mode=mode,
                                          cache=cache, pos=pos,
                                          extras=extras, rope=False)
        x = x + attn @ params["attn"]["wo"].to(dt)
        # -- cross attention ------------------------------------------------
        h = L.norm_apply(cfg, params["norm_x"], x)
        q = (h @ params["xattn"]["wq"].to(dt)).reshape(B, S, dims.n_q,
                                                       dims.head_dim)
        if mode == "decode":
            xk, xv = cache["xk"], cache["xv"]
        else:
            xk, xv = CrossLayer._cross_kv(cfg, params["xattn"], extras["enc"])
            if mode == "prefill":
                cache = dict(cache)
                cache["xk"] = xk.to(L.cdtype(cfg))
                cache["xv"] = xv.to(L.cdtype(cfg))
        xa = _attend(q, xk, xv, dims)
        x = x + xa @ params["xattn"]["wo"].to(dt)
        # -- MLP ----------------------------------------------------------------
        h = L.norm_apply(cfg, params["norm2"], x)
        x = x + L.mlp_apply(cfg, params["mlp"], h)
        return shard(x, "batch", "res_seq", "dmodel"), cache


# ---------------------------------------------------------------------------
# MoE FFN (sort-based token dispatch, capacity drop) + MoE layer
# ---------------------------------------------------------------------------


def moe_init(cfg, gen: torch.Generator):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": L.dense_init(gen, (d, e)),
        "w_in": L.dense_init(gen, (e, d, f), in_axis=1),
        "w_gate": L.dense_init(gen, (e, d, f), in_axis=1),
        "w_out": L.dense_init(gen, (e, f, d), in_axis=1),
    }


def moe_spec(cfg):
    return {
        "router": P(None, None),
        "w_in": P("experts", "fsdp", None),
        "w_gate": P("experts", "fsdp", None),
        "w_out": P("experts", None, "fsdp"),
    }


def moe_capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for a dispatch group of ``n_tokens`` tokens: the
    reference's expression, to the same Python float."""
    return max(1, int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def _moe_groups(n_tokens: int) -> int:
    """Dispatch group count = number of batch shards (halved until it
    divides ``n_tokens``), so every sort and scatter stays shard-local;
    1 without a mesh."""
    rules = current_rules()
    axes = rules.axes_for("batch")
    g = rules.mesh_size(axes) if axes else 1
    while g > 1 and n_tokens % g:
        g //= 2
    return max(g, 1)


def _rows(t, idx):
    """``t`` (G, R, D) gathered along dim 1 at ``idx`` (G, N)."""
    return torch.gather(t, 1, idx[..., None].expand(*idx.shape, t.shape[-1]))


def moe_apply(cfg, params, x, *, return_routing: bool = False):
    """Sort-based MoE dispatch in G groups of the tokens (:func:`_moe_groups`,
    one per batch shard; 1 without a mesh): per group top-k → stable sort
    by expert → capacity buffers (G, E, C, D) → expert products → combine.
    A token past its expert's capacity in its group contributes nothing.

    Every index move is injective (a gather of unique indices, or a
    scatter of unique indices: a dropped entry gets a row of its own past
    the buffers), so the forward pass and the gradients are reproducible
    on the card, where float atomics over repeated indices are not.  Each
    token's K contributions are summed in ascending expert order (the
    reference's scatter-add order), one add at a time.

    On a mesh each rank runs its own groups (:func:`_moe_on_shards`).

    ``return_routing`` also returns ``{"experts", "weights", "keep"}``,
    each (B·S, K) in top-k order, and ``"capacity"`` (per group)."""
    B, S, D = x.shape
    N = B * S
    G = _moe_groups(N)
    T = N // G
    capacity = moe_capacity(cfg, T)
    xg = shard(x.reshape(G, T, D), "batch", None, None)
    if hasattr(xg, "device_mesh"):
        if return_routing:
            raise ValueError("return_routing needs plain tensors")
        return _moe_on_shards(cfg, params, xg, capacity).reshape(B, S, D)
    out, routing = _moe_groups_apply(cfg, params, xg, capacity,
                                     routing=return_routing)
    out = out.reshape(B, S, D)
    if not return_routing:
        return out
    return out, routing


def _moe_groups_apply(cfg, params, xg, capacity, experts=None, *,
                      routing=False):
    """:func:`moe_apply` on the groups ``xg`` (G, T, D), plain tensors:
    (the output (G, T, D), the routing if ``routing`` else None).
    ``experts``, on a mesh whose rules shard the experts, is ``(split,
    gather)``: ``params`` hold this rank's experts, ``split`` takes their
    rows of the buffers (G, E, C, D), and ``gather`` makes their outputs
    every expert's."""
    G, T, D = xg.shape
    N = G * T
    K, E = cfg.top_k, cfg.n_experts
    dt = xg.dtype
    dev = xg.device

    probs = torch.softmax((xg @ params["router"].to(dt)).float(), dim=-1)
    # top-k with ties to the lower expert index, as jax.lax.top_k
    vals, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, eidx = vals[..., :K], eidx[..., :K]
    vals = vals / torch.sum(vals, dim=-1, keepdim=True)

    te = eidx.reshape(G, T * K)
    order = torch.argsort(te, dim=1, stable=True)
    se = torch.gather(te, 1, order)
    sw = torch.gather(vals.reshape(G, T * K), 1, order)
    counts = se.new_zeros((G, E)).scatter_add_(1, se, torch.ones_like(se))
    offsets = torch.cumsum(counts, 1) - counts  # exclusive, per group
    slot_pos = (torch.arange(T * K, device=dev)[None, :]
                - torch.gather(offsets, 1, se))
    keep = slot_pos < capacity

    # every sorted entry gets a row of its own: a kept one its slot
    # (e, c) at e * C + c, a dropped one a row past the buffers
    n_slots = E * capacity
    slot = torch.where(keep, se * capacity + slot_pos,
                       n_slots + torch.cumsum(~keep, 1) - 1)
    x_sorted = _rows(xg[:, :, None, :].expand(G, T, K, D).reshape(
        G, T * K, D), order)
    buf = xg.new_zeros((G, n_slots + T * K, D)).scatter(
        1, slot[..., None].expand(G, T * K, D), x_sorted)
    buf = buf[:, :n_slots].reshape(G, E, capacity, D)  # empty slots stay 0
    buf = shard(buf, "batch", "experts", None, None)
    if experts is not None:
        split, gather = experts
        buf = split(buf)

    h = F.silu(torch.einsum("gecd,edf->gecf", buf,
                            params["w_gate"].to(dt))) * torch.einsum(
        "gecd,edf->gecf", buf, params["w_in"].to(dt))
    h = shard(h, "batch", "experts", None, None)
    y = torch.einsum("gecf,efd->gecd", h, params["w_out"].to(dt))
    y = shard(y, "batch", "experts", None, None)
    if experts is not None:
        y = gather(y)

    # combine: each kept entry reads its slot, weighted; dropped read 0
    y_sorted = _rows(torch.cat([y.reshape(G, n_slots, D),
                                y.new_zeros((G, T * K, D))], dim=1), slot)
    y_sorted = y_sorted * (sw * keep).to(dt)[..., None]
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(T * K, device=dev).expand(G, T * K))
    # a token's entries in ascending sorted position = ascending expert
    y_tok = _rows(y_sorted, torch.sort(inv.view(G, T, K), dim=2)
                  .values.reshape(G, T * K)).view(G, T, K, D)
    out = y_tok[:, :, 0]
    for k in range(1, K):
        out = out + y_tok[:, :, k]
    out = shard(out, "batch", None, None)
    if not routing:
        return out, None
    return out, {"experts": eidx.reshape(N, K),
                 "weights": vals.reshape(N, K),
                 "keep": torch.gather(keep, 1, inv).view(N, K),
                 "capacity": capacity}


def _moe_on_shards(cfg, params, xg, capacity):
    """:func:`moe_apply` on a mesh, as the reference's ``shard`` points
    lay it out: each rank dispatches, computes and combines its own
    groups (``xg``'s batch shards) locally, with the router and the
    experts' weights gathered from their fsdp shards in the compute
    dtype (GSPMD's FSDP all-gather; their gradients are summed back over
    the groups' ranks).
    Where the rules shard the experts (a count the model axis divides),
    each rank computes its experts' products and the outputs are
    gathered over those ranks before the combine; where they drop it
    (granite's 40 on 16) every rank of the model axis computes all of
    them, as the reference does."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, dt = xg.device_mesh, xg.dtype
    groups = [i for i, p in enumerate(xg.placements) if p.is_shard()]
    # gathered in the compute dtype, in which every use reads them
    local = {"router": params["router"].to(dt).redistribute(
        mesh, [Replicate()] * mesh.ndim)}
    for name in ("w_gate", "w_in", "w_out"):
        local[name] = shard(params[name].to(dt), "experts", None, None)
    e_dims = [i for i, p in enumerate(local["w_gate"].placements)
              if p.is_shard()]
    local = dict(zip(local, local_shards(*local.values(), partial=groups)))
    (xl,) = local_shards(xg)
    experts = None
    if e_dims:
        whole = [Shard(0) if i in groups else Replicate()
                 for i in range(mesh.ndim)]
        split = [Shard(1) if i in e_dims else p for i, p in enumerate(whole)]
        n_groups = xg.shape[0]

        def relaid(t, src, dst):
            # the gradient comes back relaid the other way (a rank's
            # experts' rows of the buffers' gradient gathered, the
            # outputs' gradient cut to a rank's experts)
            shape = (n_groups, cfg.n_experts) + tuple(t.shape[2:])
            return from_local(t, mesh, src, shape).redistribute(
                mesh, dst).to_local()

        experts = (lambda buf: relaid(buf, whole, split),
                   lambda y: relaid(y, split, whole))
    out, _ = _moe_groups_apply(cfg, local, xl, capacity, experts)
    return from_local(out, mesh, xg.placements, xg.shape)


class MoELayer:
    FLOAT32 = ()

    @staticmethod
    def init(cfg, gen: torch.Generator):
        return {
            "norm1": L.norm_init(cfg, gen),
            "attn": L.attention_init(cfg, gen),
            "norm2": L.norm_init(cfg, gen),
            "moe": moe_init(cfg, gen),
        }

    @staticmethod
    def spec(cfg):
        return {
            "norm1": L.norm_spec(cfg),
            "attn": L.attention_spec(cfg),
            "norm2": L.norm_spec(cfg),
            "moe": moe_spec(cfg),
        }

    @staticmethod
    def init_cache(cfg, batch, max_len, device=None):
        return kv_cache_init(cfg, batch, max_len, device)

    @staticmethod
    def cache_spec(cfg):
        return kv_cache_spec(cfg)

    @staticmethod
    def apply(cfg, params, x, *, mode, cache=None, pos=None, extras=None):
        _check_mode("MoELayer", mode)
        h = L.norm_apply(cfg, params["norm1"], x)
        attn, cache = _self_attention(cfg, params["attn"], h, mode=mode,
                                      cache=cache, pos=pos, extras=extras)
        x = x + attn @ params["attn"]["wo"].to(x.dtype)
        h = L.norm_apply(cfg, params["norm2"], x)
        x = x + moe_apply(cfg, params["moe"], h)
        return shard(x, "batch", "res_seq", "dmodel"), cache
